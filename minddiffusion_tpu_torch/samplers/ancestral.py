"""GLIDE samplers with learned variance: ancestral p-sample and DDIM (port
of minddiffusion_tpu/samplers/ancestral.py).

The model emits (eps, v); the log variance interpolates between the
clipped posterior log variance and log beta with frac = (v + 1) / 2;
pred_x0 is clipped to [-1, 1] before the posterior mean; the ancestral
noise is masked out at t == 0; DDIM re-derives eps from the clipped
pred_x0. Both loops run over a respaced schedule from its last index to 0
and feed the model the original timestep (`timestep_map`), one timestep
for the whole batch as a (1,) tensor. `model_fn(x, t_orig) -> (eps, v)`,
or `model_fn(x, t_orig, arg)` with the step's entry of `step_args` (the
per-step uncond tokens of the GLIDE cascade's per-step mode).

Randomness comes from an explicit `torch.Generator`, or from `noise`
(one tensor of x's shape per step, in step order) so that a test can hand
both packages the same draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.samplers.common import broadcast_t

GlideModelFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def p_mean_variance(model_fn: GlideModelFn, schedule: DiffusionSchedule,
                    x: torch.Tensor, t: int, clip_denoised: bool = True,
                    model_args: tuple = ()):
    """(mean, log_variance, pred_x0) at spaced index `t`, fp32."""
    t_orig = broadcast_t(int(schedule.timestep_map[t]), x.device)
    eps, v = model_fn(x, t_orig, *model_args)
    eps, v = eps.float(), v.float()
    min_log = float(schedule.posterior_log_variance_clipped[t])
    max_log = float(torch.log(schedule.betas)[t])
    frac = (v + 1.0) / 2.0
    log_var = frac * max_log + (1.0 - frac) * min_log
    pred_x0 = (float(schedule.sqrt_recip_alphas_cumprod[t]) * x.float()
               - float(schedule.sqrt_recipm1_alphas_cumprod[t]) * eps)
    if clip_denoised:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    mean = (float(schedule.posterior_mean_coef1[t]) * pred_x0
            + float(schedule.posterior_mean_coef2[t]) * x.float())
    return mean, log_var, pred_x0


def _step_noise(noise, i: int, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        n = torch.as_tensor(noise[i]).float().to(x.device)
        if n.shape != x.shape:
            raise ValueError(f"noise[{i}] must be {tuple(x.shape)}, got {tuple(n.shape)}")
        return n
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)


def p_sample_loop(model_fn: GlideModelFn, x_T: torch.Tensor,
                  schedule: DiffusionSchedule,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None,
                  clip_denoised: bool = True,
                  step_args: Optional[Sequence] = None) -> torch.Tensor:
    """Ancestral sampling over every spaced step, T-1 .. 0: x <- mean +
    [t > 0] exp(log_var / 2) noise. `noise` (n_steps of x's shape) replaces
    the draws from `generator`; `step_args` (n_steps entries) are passed to
    the model as its third argument."""
    n = schedule.num_timesteps
    x = x_T.float()
    for i, t in enumerate(range(n - 1, -1, -1)):
        args = () if step_args is None else (step_args[i],)
        mean, log_var, _ = p_mean_variance(model_fn, schedule, x, t, clip_denoised, args)
        if t > 0:
            x = mean + torch.exp(0.5 * log_var) * _step_noise(noise, i, x, generator)
        else:
            x = mean
    return x


def ddim_sample_loop(model_fn: GlideModelFn, x_T: torch.Tensor,
                     schedule: DiffusionSchedule, eta: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     clip_denoised: bool = True) -> torch.Tensor:
    """DDIM over the spaced schedule: eps re-derived from the clipped
    pred_x0, x <- pred_x0 sqrt(abar_prev) + sqrt(max(1 - abar_prev -
    sigma^2, 0)) eps + [t > 0] sigma noise, sigma from `eta` (no draw at
    eta 0)."""
    n = schedule.num_timesteps
    x = x_T.float()
    for i, t in enumerate(range(n - 1, -1, -1)):
        x, _ = ddim_step(model_fn, schedule, x, t, eta, clip_denoised)
        if eta and t > 0:
            abar, abar_prev = (float(schedule.alphas_cumprod[t]),
                               float(schedule.alphas_cumprod_prev[t]))
            sigma = eta * ((1 - abar_prev) / (1 - abar) * (1 - abar / abar_prev)) ** 0.5
            x = x + sigma * _step_noise(noise, i, x, generator)
    return x


def ddim_coefficients(schedule: DiffusionSchedule, t: int, eta: float = 0.0):
    """(sqrt_recip_ac, sqrt_recipm1_ac, sqrt(abar_prev), sqrt(max(1 -
    abar_prev - sigma^2, 0))) of spaced step t as fp32 values: the four
    numbers one DDIM step reads (K9's `coefs` in "glide" mode)."""
    abar = schedule.alphas_cumprod[t]
    abar_prev = schedule.alphas_cumprod_prev[t]
    sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar)) * torch.sqrt(1 - abar / abar_prev)
    return (schedule.sqrt_recip_alphas_cumprod[t], schedule.sqrt_recipm1_alphas_cumprod[t],
            torch.sqrt(abar_prev), torch.sqrt(torch.clamp(1.0 - abar_prev - sigma ** 2, min=0.0)))


def ddim_step(model_fn: GlideModelFn, schedule: DiffusionSchedule, x: torch.Tensor,
              t: int, eta: float = 0.0, clip_denoised: bool = True):
    """One DDIM step without its noise term: (x_{t-1}, pred_x0)."""
    _, _, pred_x0 = p_mean_variance(model_fn, schedule, x, t, clip_denoised)
    sr, srm1, sap, s1map = (float(c) for c in ddim_coefficients(schedule, t, eta))
    eps = (sr * x - pred_x0) / srm1
    return pred_x0 * sap + s1map * eps, pred_x0
