"""DDIM sampler (port of minddiffusion_tpu/samplers/ddim.py).

Song et al. (arXiv:2010.02502) with the reference's table conventions:
timesteps range(0, T, T//S) + 1 (or the "quad" subset, `method=`),
alpha_prev with alphas_cumprod[0] prepended,
sigma = eta * sqrt((1-a_prev)/(1-a) * (1-a/a_prev)). Supports
eta > 0 (noise from a torch.Generator), a mid-chain start
(`t_start_index`, img2img) and latent inpainting via (mask, x0) blending.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from minddiffusion_tpu_torch.core.schedules import (
    DiffusionSchedule, ddim_sampling_parameters, make_ddim_timesteps)
from minddiffusion_tpu_torch.samplers import common


def build_tables(schedule: DiffusionSchedule, num_steps: int,
                 eta: float = 0.0, method: str = "uniform") -> dict:
    """Per-step (t, alpha, alpha_prev, sigma) in descending t order over
    the `method` ("uniform" or "quad") timestep subset."""
    ac = schedule.alphas_cumprod.double().numpy()
    ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method)
    sigmas, alphas, alphas_prev = ddim_sampling_parameters(ac, ts, eta)
    f32 = lambda x: np.asarray(x[::-1], dtype=np.float32)  # noqa: E731
    return dict(t=np.asarray(ts[::-1], dtype=np.int64), alpha=f32(alphas),
                alpha_prev=f32(alphas_prev), sigma=f32(sigmas))


def sample(eps_fn: common.EpsFn, x_T: torch.Tensor, schedule: DiffusionSchedule,
           num_steps: int = 50, eta: float = 0.0,
           generator: Optional[torch.Generator] = None,
           mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
           t_start_index: Optional[int] = None,
           method: str = "uniform") -> torch.Tensor:
    """Run the DDIM chain; returns the final latent (fp32).
    `t_start_index`: number of steps actually run (img2img strength < 1);
    `method`: the timestep subset (`build_tables`)."""
    tables = build_tables(schedule, num_steps, eta, method)
    start = num_steps - (t_start_index if t_start_index is not None else num_steps)
    blend = common.masked_blend_fn(mask, x0, schedule.sqrt_alphas_cumprod,
                                   schedule.sqrt_one_minus_alphas_cumprod, generator)
    x = x_T.float()
    dev = x.device
    for i in range(start, num_steps):
        t = int(tables["t"][i])
        a_t = common.device_scalar(tables["alpha"][i], dev)
        a_prev = common.device_scalar(tables["alpha_prev"][i], dev)
        sigma_t = common.device_scalar(tables["sigma"][i], dev)
        x = blend(x, t)
        eps = eps_fn(x, common.broadcast_t(t, dev)).float()
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2, min=0.0)) * eps
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if tables["sigma"][i] != 0.0:
            x = x + sigma_t * torch.randn(x.shape, generator=generator,
                                          device=dev, dtype=torch.float32)
    return x
