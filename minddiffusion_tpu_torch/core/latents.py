"""Latent scaling, the inpaint blend and image quantization (port of
minddiffusion_tpu/core/latents.py)."""
from __future__ import annotations

import torch

DEFAULT_SCALE_FACTOR = 0.18215


def scale_latents(z: torch.Tensor,
                  scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    return z * scale_factor


def unscale_latents(z: torch.Tensor,
                    scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    return z / scale_factor


def blend_masked(x: torch.Tensor, x_known_noised: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Latent inpainting blend: the known region (mask == 1) from the
    noised original, the rest from x (plms.py:156-159)."""
    return x_known_noised * mask + x * (1.0 - mask)


def images_to_unit_range(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] HWC -> fp32 [-1, 1]."""
    return images_uint8.float() / 127.5 - 1.0


def unit_range_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """fp32 [-1, 1] -> uint8 [0, 255], clipped; rounds half to even."""
    x = torch.clamp((x.float() + 1.0) * 127.5, 0.0, 255.0)
    return torch.round(x).to(torch.uint8)
