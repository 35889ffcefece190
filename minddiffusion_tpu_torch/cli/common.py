"""Shared CLI plumbing: model building, weight loading, tokenizers, image saving."""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from minddiffusion_tpu_torch.pipelines.stable_diffusion import FAMILIES, SDModels

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
ORBAX_REFUSED = ("an orbax directory: orbax checkpoints are read where the JAX package "
                 "runs and carried to the port by io/sd_weights.state_dict_from_jax "
                 "(io/glide_weights for GLIDE)")
_TORCH_MAGIC = (b"PK", b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")
# softmax at the packed-attention sites: SD2 runs the raw-exp mode of the
# main-path bench; the wukong families keep the JAX CLI's exact softmax
ATTN_IMPL = {"sd2": "fast", "wukong": None, "wukong-inpaint": None}


def resolve_device(name: str) -> torch.device:
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def tiny_configs(family: str) -> dict:
    """A structurally complete miniature of `family` for smoke tests."""
    from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
    from minddiffusion_tpu_torch.models.unet import UNetConfig
    from minddiffusion_tpu_torch.models.vae import VAEConfig

    kw = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1, 2),
              channel_mult=(1, 2), context_dim=32, attn_impl=ATTN_IMPL[family])
    if family == "sd2":
        unet = UNetConfig(num_head_channels=8, **kw)
    else:
        unet = UNetConfig(in_channels=9 if family == "wukong-inpaint" else 4,
                          num_heads=4, use_linear_in_transformer=False, **kw)
    return dict(unet_config=unet,
                vae_config=VAEConfig(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1),
                text_config=CLIPTextConfig(width=32, layers=2, heads=4,
                                           use_quick_gelu=family != "sd2"))


def read_checkpoint(path: str) -> dict:
    """A checkpoint as flat numpy arrays (floats in fp32), resolved as the
    JAX CLI resolves --ckpt: .safetensors, then a torch pickle or zip
    (its "state_dict" entry if it has one), then a MindSpore protobuf
    (renamed to LDM names). Orbax directories are refused."""
    from minddiffusion_tpu_torch.io import ms_checkpoint, sd_weights

    if os.path.isdir(path):
        raise SystemExit(f"--ckpt {path}: {ORBAX_REFUSED}")
    if path.endswith(".safetensors"):
        return sd_weights.load_safetensors(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in _TORCH_MAGIC:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj)
        return {k: v.float().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return ms_checkpoint.ms_to_ldm_names(ms_checkpoint.load_ms_checkpoint(path))


def build_sd(family: str, dtype_str: str, device: torch.device, tiny: bool = False,
             ckpt_path: Optional[str] = None, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None,
             enable_lora: bool = False, exact_attention: bool = False,
             lora_rank: int = 4, lora_alpha: float = 4.0) -> SDModels:
    """SD models with weights from an LDM-named checkpoint (`read_checkpoint`:
    .safetensors, torch or MindSpore), or seeded random weights (with a
    warning) when no checkpoint is given.
    `tiny`: a structurally complete miniature for smoke tests.
    `param_dtype` torch.float32 keeps fp32 master weights under `dtype_str`
    compute (training); `enable_lora` adds the UNet's LoRA adapters, drawn
    from `seed` (A ~ N(0, 0.02^2), B = 0) where the checkpoint has none,
    at `lora_rank` with scale `lora_alpha` / `lora_rank`.
    `exact_attention`: exact softmax at every kernel site, as the JAX train
    CLI builds its models (its txt2img takes ATTN_IMPL's raw-exp for sd2)."""
    attn_impl = None if exact_attention else ATTN_IMPL[family]
    configs = tiny_configs(family) if tiny else {}
    lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha) if enable_lora else {}
    if tiny:
        configs["unet_config"] = dataclasses.replace(
            configs["unet_config"], attn_impl=attn_impl, enable_lora=enable_lora, **lora)
    elif lora and family in FAMILIES:
        configs["unet_config"] = FAMILIES[family][0](attn_impl=attn_impl, enable_lora=True,
                                                     **lora)
    generator = torch.Generator(device=device).manual_seed(seed)
    if ckpt_path is None:
        print("WARNING: no checkpoint given — using RANDOM weights (noise images)")
    models = SDModels.create(family=family, dtype=DTYPES[dtype_str],
                             attn_impl=attn_impl, device=device,
                             generator=generator if ckpt_path is None else None,
                             param_dtype=param_dtype, enable_lora=enable_lora, **configs)
    if ckpt_path is not None:
        prefixes = ("model.diffusion_model.", "first_stage_model.",
                    "cond_stage_model.model.")
        sd = {k: v for k, v in read_checkpoint(ckpt_path).items() if k.startswith(prefixes)}
        if enable_lora:
            from minddiffusion_tpu_torch.models.lora import is_lora_name

            for name, p in models.unet.named_parameters():
                key = "model.diffusion_model." + name
                if is_lora_name(name) and key not in sd:
                    std = 0.02 if name.endswith(".lora_a") else 0.0
                    sd[key] = (torch.randn(p.shape, generator=generator, device=device)
                               * std).float().cpu().numpy()
        models.load_state_dict(sd)
    return models


def tokenizer_for(family: str):
    """CLIP BPE for sd2, the zh wordpiece for the wukong families."""
    from minddiffusion_tpu_torch.text import ClipBpeTokenizer, WordpieceZhTokenizer

    return ClipBpeTokenizer() if family == "sd2" else WordpieceZhTokenizer()


def save_images(images_uint8: torch.Tensor, outdir: str, prefix: str = "") -> list:
    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    existing = len([f for f in os.listdir(outdir) if f.endswith(".png")])
    paths = []
    for i, arr in enumerate(np.asarray(images_uint8.cpu())):
        p = os.path.join(outdir, f"{prefix}{existing + i:05d}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths
