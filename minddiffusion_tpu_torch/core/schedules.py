"""Diffusion noise schedule and DDIM sub-schedules.

Port of minddiffusion_tpu/core/schedules.py (the SD parts): tables are
computed once on the host in float64 numpy and stored as fp32 tensors.
SD "linear" schedule: betas = linspace(sqrt(start), sqrt(end), T)**2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(n_timestep: int = 1000, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """SD sqrt-space linear betas, float64 (n_timestep,)."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep tables (fp32, on the host) the SD samplers read."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    num_timesteps: int

    @classmethod
    def from_betas(cls, betas: np.ndarray) -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
        return cls(betas=f32(betas), alphas_cumprod=f32(alphas_cumprod),
                   sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
                   sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
                   num_timesteps=int(betas.shape[0]))

    @classmethod
    def create(cls, n_timestep: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2) -> "DiffusionSchedule":
        return cls.from_betas(make_beta_schedule(n_timestep, linear_start, linear_end))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t (int, (B,)), fp32:
        sqrt(ac[t]) * x_start + sqrt(1 - ac[t]) * noise."""
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        t = t.to("cpu", torch.int64)
        a = self.sqrt_alphas_cumprod[t].reshape(shape).to(x_start.device)
        s = self.sqrt_one_minus_alphas_cumprod[t].reshape(shape).to(x_start.device)
        return a * x_start.float() + s * noise.float()


def make_ddim_timesteps(num_ddim_timesteps: int,
                        num_ddpm_timesteps: int = 1000) -> np.ndarray:
    """The "uniform" DDIM timestep subset, int64 ascending, shifted by +1."""
    if not 1 <= num_ddim_timesteps <= num_ddpm_timesteps:
        raise ValueError(f"num_ddim_timesteps must be in [1, {num_ddpm_timesteps}],"
                         f" got {num_ddim_timesteps}")
    c = num_ddpm_timesteps // num_ddim_timesteps
    if c == 1:
        # more than T/2 steps: an evenly spaced in-range subsequence
        return np.linspace(0, num_ddpm_timesteps - 1,
                           num_ddim_timesteps).round().astype(np.int64)
    return np.arange(num_ddim_timesteps, dtype=np.int64) * c + 1


def ddim_sampling_parameters(alphas_cumprod, ddim_timesteps: np.ndarray,
                             eta: float = 0.0):
    """(sigmas, alphas, alphas_prev) for the chosen DDIM subset, float64."""
    alphas_cumprod = np.asarray(alphas_cumprod, dtype=np.float64)
    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.concatenate([[alphas_cumprod[0]],
                                  alphas_cumprod[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev
