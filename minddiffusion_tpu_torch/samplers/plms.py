"""PLMS (pseudo linear multistep) sampler (port of minddiffusion_tpu/samplers/plms.py).

Order ramp: Euler bootstrap with a second model eval at the next timestep
(order 1), then 2nd-, 3rd- and 4th-order Adams-Bashforth on eps. A
PLMS-S chain runs S + 1 model evals.
"""
from __future__ import annotations

from typing import Optional

import torch

from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.samplers import common
from minddiffusion_tpu_torch.samplers.ddim import build_tables


def sample(eps_fn: common.EpsFn, x_T: torch.Tensor, schedule: DiffusionSchedule,
           num_steps: int = 50, eta: float = 0.0,
           generator: Optional[torch.Generator] = None,
           mask: Optional[torch.Tensor] = None,
           x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    if eta != 0.0:
        raise ValueError("eta must be 0 for PLMS")
    tables = build_tables(schedule, num_steps, eta=0.0)
    n = len(tables["t"])
    blend = common.masked_blend_fn(mask, x0, schedule.sqrt_alphas_cumprod,
                                   schedule.sqrt_one_minus_alphas_cumprod, generator)
    x = x_T.float()
    dev = x.device

    def x_prev_from_eps(x, e_t, a_t, a_prev):
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * e_t

    hist = []  # previous eps, newest last
    for i in range(n):
        t = int(tables["t"][i])
        t_next = int(tables["t"][min(i + 1, n - 1)])
        a_t = common.device_scalar(tables["alpha"][i], dev)
        a_prev = common.device_scalar(tables["alpha_prev"][i], dev)
        x = blend(x, t)
        e_t = eps_fn(x, common.broadcast_t(t, dev)).float()
        if i == 0:
            x_pred = x_prev_from_eps(x, e_t, a_t, a_prev)
            e_next = eps_fn(x_pred, common.broadcast_t(t_next, dev)).float()
            e_prime = (e_t + e_next) / 2.0
        elif i == 1:
            e_prime = (3.0 * e_t - hist[-1]) / 2.0
        elif i == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[-1] + 5.0 * hist[-2]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[-1] + 37.0 * hist[-2]
                       - 9.0 * hist[-3]) / 24.0
        x = x_prev_from_eps(x, e_prime, a_t, a_prev)
        hist = (hist + [e_t])[-3:]
    return x
