"""Shared set-up of the JAX-vs-port parity tests (tests/test_torch_*.py).

Tiny models of one family ("sd2": head_dim 8, linear proj_in/out, tanh-GELU
CLIP; "wukong" / "wukong-inpaint": 4 heads, 1x1-conv proj_in/out, QuickGELU
CLIP, the inpaint UNet with 9 input channels) are built in both packages
with the same weights:
every JAX param leaf is overwritten with seeded numpy values (JAX init
zeroes out_conv, each ResBlock conv_out and each SpatialTransformer
proj_out, which would make eps identically zero and hide attention), then
exported with the port's converter and loaded strictly into the port.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from minddiffusion_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from minddiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from minddiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from minddiffusion_tpu.pipelines.stable_diffusion import SDModels as JaxSDModels
from minddiffusion_tpu_torch.io.sd_weights import state_dict_from_jax
from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
from minddiffusion_tpu_torch.models.unet import UNetConfig
from minddiffusion_tpu_torch.models.vae import VAEConfig
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

UNET_KW = dict(model_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2),
               num_res_blocks=1, context_dim=32)
FAMILY_UNET_KW = {
    "sd2": dict(num_head_channels=8, use_linear_in_transformer=True),
    "wukong": dict(num_heads=4, use_linear_in_transformer=False),
    "wukong-inpaint": dict(num_heads=4, use_linear_in_transformer=False, in_channels=9),
}
VAE_KW = dict(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
CLIP_KW = dict(vocab_size=49408, width=32, layers=2, heads=4, context_length=77)


def randomize(tree, seed: int):
    """Every leaf replaced by seeded numpy values at the SD scale: matrices
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), vectors N(0, 0.1^2),
    embeddings N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name in ("token_embedding", "positional_embedding"):
            return rng.normal(0, 0.02, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0, 0.1, shape)).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_models(attn_impl=None, family: str = "sd2") -> JaxSDModels:
    return JaxSDModels.create(
        family=family, dtype=jnp.float32, attn_impl=attn_impl,
        unet_config=JaxUNetConfig(attn_impl=attn_impl, **UNET_KW, **FAMILY_UNET_KW[family]),
        vae_config=JaxVAEConfig(**VAE_KW),
        text_config=JaxCLIPConfig(use_quick_gelu=family != "sd2", **CLIP_KW))


def jax_params(models: JaxSDModels, seed: int = 0, size: int = 256) -> dict:
    """Seeded numpy params in the tree of `models.init_params`. Only the
    tree's shapes are needed, so the init is traced (`jax.eval_shape`), not
    run: running it eagerly costs ~50 s of op compiles per process."""
    shapes = jax.eval_shape(
        lambda: models.init_params(jax.random.PRNGKey(0), height=size, width=size))
    return randomize(shapes, seed)


def port_models(jmodels: JaxSDModels, params: dict, attn_impl=None,
                family: str = "sd2") -> SDModels:
    """The port's fp32 CPU models carrying `params` (loaded strictly)."""
    models = SDModels.create(
        family=family, dtype=torch.float32, device="cpu",
        unet_config=UNetConfig(attn_impl=attn_impl, **UNET_KW, **FAMILY_UNET_KW[family]),
        vae_config=VAEConfig(**VAE_KW),
        text_config=CLIPTextConfig(use_quick_gelu=family != "sd2", **CLIP_KW))
    models.load_state_dict(state_dict_from_jax(params, jmodels.unet.config))
    return models


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))
