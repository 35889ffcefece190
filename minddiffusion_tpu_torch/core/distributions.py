"""Diagonal Gaussian posterior of the KL-VAE (port of
minddiffusion_tpu/core/distributions.py).

The VAE encoder emits concat(mean, logvar) on the channel (last) axis;
`sample` draws its noise from an explicit generator or takes it as `eps`.
"""
from __future__ import annotations

from typing import Optional

import torch


def split_moments(moments: torch.Tensor):
    """(..., 2C) channel-last moments -> (mean, logvar), logvar clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def sample(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * eps, eps ~ N(0, I) from `generator` unless given."""
    mean, logvar = split_moments(moments)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    elif eps.shape != mean.shape:
        raise ValueError(f"eps must be {tuple(mean.shape)}, got {tuple(eps.shape)}")
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.device, mean.dtype)


def mode(moments: torch.Tensor) -> torch.Tensor:
    return split_moments(moments)[0]


def kl(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) per batch element, summed over the other dims."""
    mean, logvar = split_moments(moments)
    return 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar,
                           dim=tuple(range(1, mean.ndim)))
