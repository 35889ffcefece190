"""Latent scaling and image quantization (port of minddiffusion_tpu/core/latents.py)."""
from __future__ import annotations

import torch

DEFAULT_SCALE_FACTOR = 0.18215


def scale_latents(z: torch.Tensor,
                  scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    return z * scale_factor


def unscale_latents(z: torch.Tensor,
                    scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    return z / scale_factor


def unit_range_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """fp32 [-1, 1] -> uint8 [0, 255], clipped; rounds half to even."""
    x = torch.clamp((x.float() + 1.0) * 127.5, 0.0, 255.0)
    return torch.round(x).to(torch.uint8)
