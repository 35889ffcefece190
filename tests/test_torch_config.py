"""The port's MDT_WINO flag, YAML model configs, factories, SDModels.create
keywords and latents helpers against the JAX package (CPU).

- MDT_WINO: the JAX grammar ("0" switches the Winograd kernels off, any
  other value leaves them on), `wino_route` False at every gated shape
  under "0", and a gated conv then on the non-Winograd route with no
  Winograd transform computed, in inference (with the hoisted U cache) and
  in training.
- YAML: `get_obj_from_str`, `instantiate_from_config` and `load_yaml`
  beside the JAX ones; each config under minddiffusion_tpu_torch/configs/
  built on the meta device, its family, dtype, network configs and
  schedule tables equal to what the JAX package builds from the repo's
  configs/ file of the same name, its `sampling` block the same.
- `SDModels.create`'s schedule and LoRA keywords against the JAX create,
  and its defaults against the FAMILIES presets and SD's schedule.
- `blend_masked` and `images_to_unit_range` bitwise against the JAX ones.
"""
import collections
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddiffusion_tpu.core import latents as jax_latents
from minddiffusion_tpu.pipelines import stable_diffusion as jax_sd
from minddiffusion_tpu.utils import flags as jax_flags
from minddiffusion_tpu_torch.core import latents
from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.models import layers
from minddiffusion_tpu_torch.ops import winograd
from minddiffusion_tpu_torch.pipelines import glide_cascade
from minddiffusion_tpu_torch.pipelines import stable_diffusion as port_sd
from minddiffusion_tpu_torch.utils import config
from minddiffusion_tpu_torch.utils.flags import flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "minddiffusion_tpu_torch", "configs",
                                             "*.yaml")))
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
          "timestep_map")


@pytest.mark.parametrize("raw", [None, "", "1", "0", "00", "off", " 0"])
def test_mdt_wino_grammar_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("MDT_WINO", raising=False)
    else:
        monkeypatch.setenv("MDT_WINO", raw)
    assert flags().wino == jax_flags.flags().wino == (raw != "0")


# Shapes the gate routes by default: the SD2 / SD1 / GLIDE sites at 32^2
# and 16^2 with C_in >= 512, and the gate's edges (min side 12 and 48).
GATED = [(h, w, c) for h, w in ((12, 12), (16, 16), (32, 32), (48, 48), (16, 24), (32, 48))
         for c in (512, 640, 768, 1280, 1920, 2560)]


@pytest.mark.parametrize("tune", ["", "hmax=64,cmin=256", "dma=0"])
def test_wino_route_is_off_at_every_gated_shape_under_mdt_wino_0(monkeypatch, tune):
    monkeypatch.setenv("MDT_WINO_TUNE", tune)
    monkeypatch.delenv("MDT_WINO", raising=False)
    assert all(winograd.wino_route(*s) for s in GATED)
    monkeypatch.setenv("MDT_WINO", "0")
    assert not any(winograd.wino_route(*s) for s in GATED)
    assert not any(winograd.wino_route(h, h, c) for h in range(2, 130, 2)
                   for c in (8, 320, 512, 4096))


@pytest.mark.parametrize("train", [False, True])
def test_gated_conv_takes_the_plain_route_under_mdt_wino_0(monkeypatch, train):
    """A Conv3x3 at a gated shape (16^2, C_in 512) under MDT_WINO=0: no
    Winograd piece runs (each raises if called), nothing enters the
    hoisted U cache, and the result is conv3x3_nhwc's on the GN + SiLU
    input."""
    monkeypatch.setenv("MDT_WINO", "0")

    def refuse(*a, **kw):
        raise AssertionError("a Winograd piece ran under MDT_WINO=0")

    for name in ("transform_weights", "winograd_plain", "winograd_gathered_plain",
                 "conv3x3_winograd", "conv3x3_winograd_gathered", "conv3x3_winograd_ad"):
        monkeypatch.setattr(winograd, name, refuse)
    g = torch.Generator().manual_seed(3)
    conv = layers.Conv3x3(512, 16)
    x = torch.randn(1, 16, 16, 512, generator=g)
    gn = (torch.rand(1, 512, generator=g) + 0.5, torch.randn(1, 512, generator=g))
    conv.wino_cache = {}
    with torch.set_grad_enabled(train):
        if train:
            x.requires_grad_()
        y = conv(x, gn)
        ref = layers.conv3x3_nhwc(layers._gn_silu(x, gn), conv.weight, conv.bias)
    assert conv.wino_cache == {}
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    if train:
        y.sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()


def test_get_obj_and_instantiate_from_config_match_jax(tmp_path):
    from minddiffusion_tpu.utils import config as jax_config

    assert config.get_obj_from_str("minddiffusion_tpu_torch.core.latents.blend_masked") \
        is latents.blend_masked
    spec = {"target": "minddiffusion_tpu_torch.core.schedules.make_beta_schedule",
            "params": {"schedule": "quad", "n_timestep": 50, "linear_start": 1e-3,
                       "linear_end": 3e-2}}
    jax_spec = dict(spec, target="minddiffusion_tpu.core.schedules.make_beta_schedule")
    np.testing.assert_array_equal(config.instantiate_from_config(spec),
                                  jax_config.instantiate_from_config(jax_spec))
    for fn in (config.instantiate_from_config, jax_config.instantiate_from_config):
        with pytest.raises(KeyError, match="no target"):
            fn({"params": {}})
    pytest.importorskip("yaml")
    path = tmp_path / "c.yaml"
    path.write_text("model:\n  target: a.b\n  params: {dtype: bf16, timesteps: 1000}\n"
                    "sampling:\n  steps: 50\n  scale: 9.0\n")
    assert config.load_yaml(str(path)) == jax_config.load_yaml(str(path))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def hold_config(port_cfg, jax_cfg) -> None:
    """Every field the two packages' configs share is equal."""
    p, j = _fields(port_cfg), _fields(jax_cfg)
    shared = set(p) & set(j)
    assert len(shared) >= 4
    assert {k: p[k] for k in shared} == {k: j[k] for k in shared}


def hold_schedule(port: DiffusionSchedule, ref) -> None:
    assert port.num_timesteps == ref.num_timesteps
    for name in TABLES:
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-12, rtol=0, err_msg=name)


def params_dtype(module: torch.nn.Module) -> torch.dtype:
    """The dtype of the module's weights (the norms stay fp32)."""
    counts = collections.Counter()
    for p in module.parameters():
        counts[p.dtype] += p.numel()
    return counts.most_common(1)[0][0]


def test_every_jax_config_has_a_port_config():
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                                       "*.yaml")))
    assert names == [os.path.basename(p) for p in PORT_CONFIGS] and len(names) == 4


@pytest.mark.parametrize("path", PORT_CONFIGS, ids=os.path.basename)
def test_port_yaml_config_builds_what_the_jax_config_builds(path):
    """The port's config on the meta device (no weights) against the JAX
    package's instantiation of configs/<same name>."""
    from minddiffusion_tpu.utils import config as jax_config

    pytest.importorskip("yaml")
    cfg = config.load_yaml(path)
    jcfg = jax_config.load_yaml(os.path.join(ROOT, "configs", os.path.basename(path)))
    assert cfg["sampling"] == jcfg["sampling"]
    assert cfg["model"]["params"] == jcfg["model"]["params"]
    assert cfg["model"]["target"] == jcfg["model"]["target"].replace(
        "minddiffusion_tpu.", "minddiffusion_tpu_torch.")
    model = config.instantiate_from_config(
        {**cfg["model"], "params": {**cfg["model"]["params"], "device": "meta"}})
    ref = jax_config.instantiate_from_config(jcfg["model"])
    jdtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    if isinstance(model, port_sd.SDModels):
        family = cfg["model"]["params"]["family"]
        unet_preset, text_preset = port_sd.FAMILIES[family]
        assert model.unet.config == unet_preset()
        assert model.text_encoder.config == text_preset()
        for port_net, jax_net in ((model.unet, ref.unet), (model.vae, ref.vae),
                                  (model.text_encoder, ref.text_encoder)):
            hold_config(port_net.config, jax_net.config)
            assert params_dtype(port_net) == jdtype[jax_net.config.dtype]
            assert next(port_net.parameters()).device.type == "meta"
        hold_schedule(model.schedule, ref.schedule)
        assert model.scale_factor == ref.scale_factor
    else:
        assert isinstance(model, glide_cascade.GlideModels)
        for port_net, jax_net in ((model.base, ref.base), (model.super_res, ref.super_res)):
            hold_config(port_net.unet_config, jax_net.unet_config)
            hold_config(port_net.xf_config, jax_net.xf_config)
            assert params_dtype(port_net) == jdtype[jax_net.unet_config.dtype]
        assert (model.srgan is None) == (ref.srgan is None)
        hold_schedule(model.base_schedule, ref.base_schedule)
        hold_schedule(model.sr_schedule, ref.sr_schedule)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_factories_map_the_dtype_names(dtype):
    want = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    sd = port_sd.create_sd_models(family="wukong", dtype=dtype, device="meta")
    assert params_dtype(sd.unet) == want
    glide = glide_cascade.create_glide_models(dtype=dtype, device="meta", with_srgan=False)
    assert params_dtype(glide.base) == want and glide.srgan is None
    with pytest.raises(KeyError):
        port_sd.create_sd_models(dtype="fp16", device="meta")


def test_factories_default_to_the_card():
    """As every entry point: the device is CUDA unless the params ask for
    another (fp32 is refused there, the kernels take bf16)."""
    with pytest.raises(ValueError, match="CUDA kernels take bfloat16"):
        port_sd.create_sd_models(dtype="fp32")
    with pytest.raises(ValueError, match="CUDA kernels take bfloat16"):
        glide_cascade.create_glide_models(dtype="fp32")


@pytest.mark.parametrize("kw", [
    dict(timesteps=500, linear_start=1e-4, linear_end=2e-2),
    dict(enable_lora=True, lora_rank=8, lora_alpha=16.0),
    dict(family="wukong", enable_lora=True, lora_rank=2, lora_alpha=1.0, timesteps=800),
])
def test_sd_models_create_keywords_match_jax(kw):
    port = port_sd.SDModels.create(device="meta", dtype=torch.float32, **kw)
    ref = jax_sd.SDModels.create(dtype=jnp.float32, **kw)
    hold_schedule(port.schedule, ref.schedule)
    hold_config(port.unet.config, ref.unet.config)
    adapters = {(m.rank, m.alpha, m.lora_a.shape[1], m.lora_b.shape[0])
                for m in port.unet.modules() if hasattr(m, "lora_a")}
    r, alpha = kw.get("lora_rank"), kw.get("lora_alpha")
    assert adapters == ({(r, alpha, r, r)} if kw.get("enable_lora") else set())


@pytest.mark.parametrize("family", list(port_sd.FAMILIES))
def test_sd_models_create_defaults_are_the_presets(family):
    """No keyword changes the FAMILIES presets: the preset UNet, SD's linear
    schedule 0.00085-0.0120 over 1000 steps, LoRA rank 4, alpha 4."""
    models = port_sd.SDModels.create(family=family, device="meta")
    assert models.unet.config == port_sd.FAMILIES[family][0]()
    assert (models.unet.config.lora_rank, models.unet.config.lora_alpha) == (4, 4.0)
    hold_schedule(models.schedule, jax_sd.SDModels.create(family=family).schedule)
    ref = DiffusionSchedule.create(1000, 0.00085, 0.0120)
    for name in TABLES:
        assert torch.equal(getattr(models.schedule, name), getattr(ref, name)), name


def test_latents_helpers_match_jax():
    rng = np.random.default_rng(9)
    x, known = (rng.standard_normal((2, 4, 5, 4)).astype(np.float32) for _ in range(2))
    for mask in ((rng.uniform(size=(2, 4, 5, 1)) > 0.5).astype(np.float32),
                 rng.uniform(size=(2, 4, 5, 4)).astype(np.float32)):
        got = latents.blend_masked(*(torch.from_numpy(a) for a in (x, known, mask)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_latents.blend_masked(
            jnp.asarray(x), jnp.asarray(known), jnp.asarray(mask))))
    img = rng.integers(0, 256, (2, 7, 6, 3), dtype=np.uint8)
    img[0, 0, 0, :2] = 0, 255
    got = latents.images_to_unit_range(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_latents.images_to_unit_range(jnp.asarray(img))))
    assert got.min() == -1.0 and got.max() == 1.0
