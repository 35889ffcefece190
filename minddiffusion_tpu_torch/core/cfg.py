"""Classifier-free guidance folded onto the batch axis (halves layout).

Port of minddiffusion_tpu/core/cfg.py: the folded batch is [uncond; cond].
Only the halves layout is ported; the JAX package's interleaved pairs serve
its dp-mesh rewrite, which the port does not have.
"""
from __future__ import annotations

from typing import Callable

import torch


def fold(uncond: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return torch.cat([uncond, cond], dim=0)


def duplicate(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x], dim=0)


def guide(eps_folded: torch.Tensor, scale: float) -> torch.Tensor:
    """eps = eps_uncond + scale * (eps_cond - eps_uncond)."""
    eps_uncond, eps_cond = eps_folded.chunk(2, dim=0)
    return eps_uncond + scale * (eps_cond - eps_uncond)


def wrap_model(apply_fn: Callable, folded_cond: torch.Tensor, scale: float,
               dedup: bool = False) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(x, t, cond) -> eps model into a guided (x, t) -> eps model. x has
    batch B and is duplicated; a batch-1 t broadcasts against both halves.

    `dedup=True`: apply_fn takes x and t at batch B (not duplicated) and
    returns the 2B [uncond; cond] output itself: the UNet's cfg_fold path,
    which runs the network's prefix once instead of twice."""

    def guided(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if dedup:
            return guide(apply_fn(x, t, folded_cond), scale)
        t2 = t if t.shape[0] == 1 else duplicate(t)
        return guide(apply_fn(duplicate(x), t2, folded_cond), scale)

    return guided


def cfg_dup(x: torch.Tensor) -> torch.Tensor:
    """A batch-B activation onto both guidance halves, where the UNet's
    cfg_fold path widens to 2B (models/unet, models/attention)."""
    return duplicate(x)
