"""Shared sampler plumbing (port of minddiffusion_tpu/samplers/common.py).

A sampler is a function `sample(eps_fn, x_T, schedule, ...) -> x_0` whose
step loop is a Python loop; per-step scalars (timesteps, alphas, sigmas)
are host tables built in float64 numpy and stored as fp32.
`eps_fn(x, t) -> eps` is the CFG-wrapped denoiser (core/cfg.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from minddiffusion_tpu_torch.core import latents

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def broadcast_t(t: int, device) -> torch.Tensor:
    """One timestep for the whole batch, as a batch-1 (1,) tensor: the time
    embedding runs at batch 1 and broadcasts against the activations."""
    return torch.full((1,), int(t), dtype=torch.int64, device=device)


def broadcast_time(t: float, device) -> torch.Tensor:
    """A continuous model time (the DPM solvers' nodes) as a batch-1 fp32
    (1,) tensor; `t` is taken at fp32, as the solvers' tables hold it."""
    return torch.full((1,), float(t), dtype=torch.float32, device=device)


def device_scalar(value: float, device) -> torch.Tensor:
    """`value` at fp32 as a 0-d tensor on `device`, made by a fill there:
    `torch.tensor(value, device="cuda")` copies from pageable host memory,
    which synchronises the stream and would stall a caller that keeps work
    in flight (the serving engine)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def masked_blend_fn(mask: Optional[torch.Tensor], x0: Optional[torch.Tensor],
                    sqrt_ac: torch.Tensor, sqrt_1mac: torch.Tensor,
                    generator: Optional[torch.Generator]):
    """blend(x, t): latent-inpaint keep-region blending, or identity.
    x <- q_sample(x0, t) * mask + x * (1 - mask); mask == 1 marks the kept
    region. The noise is drawn from `generator`."""
    if mask is None:
        return lambda x, t: x

    def blend(x: torch.Tensor, t: int) -> torch.Tensor:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=torch.float32)
        x0_noised = float(sqrt_ac[t]) * x0 + float(sqrt_1mac[t]) * noise
        return latents.blend_masked(x, x0_noised, mask)

    return blend
