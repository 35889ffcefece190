"""Diffusion noise schedules, DDIM sub-schedules and GLIDE respacing.

Port of minddiffusion_tpu/core/schedules.py: tables are computed once on the
host in float64 numpy and stored as fp32 tensors (moved to the device by the
samplers that read them).

  * SD "linear": betas = linspace(sqrt(start), sqrt(end), T)**2, and
    "quad", the same ramp under the name of the reference's configs;
  * GLIDE "linear_plain": linspace(1e-4, 2e-2, T) scaled by 1000/T, and
    "squaredcos_cap_v2": the cosine alpha-bar schedule, betas capped at
    0.999 (`betas_for_alpha_bar`);
  * `space_timesteps` (the "ddimN", "fast27" and comma-section grammar) and
    `respace_schedule`, whose betas reproduce the original alpha-bar at the
    kept timesteps; `timestep_map` maps a spaced index to the original t;
  * `v_posterior`, the weight of beta in the posterior variance
    (1 - v) * beta * (1 - ac_prev) / (1 - ac) + v * beta;
  * the DDIM timestep subsets "uniform" and "quad" (`make_ddim_timesteps`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Set, Union

import numpy as np
import torch


def make_beta_schedule(n_timestep: int = 1000, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, schedule: str = "linear",
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Betas of a named schedule, float64 (n_timestep,): "linear" (SD
    sqrt-space) or its alias "quad", "linear_plain" (GLIDE: linear in beta,
    scaled by 1000 / n_timestep; `linear_start`/`linear_end` are not read)
    or "squaredcos_cap_v2"."""
    if schedule in ("linear", "quad"):
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "linear_plain":
        scale = 1000.0 / n_timestep
        return np.linspace(scale * 1e-4, scale * 2e-2, n_timestep, dtype=np.float64)
    if schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            n_timestep,
            lambda t: math.cos((t + cosine_s) / (1 + cosine_s) * math.pi / 2) ** 2)
    raise ValueError(f"unknown beta schedule: {schedule!r}")


def betas_for_alpha_bar(n_timestep: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas (float64)."""
    t = np.arange(n_timestep, dtype=np.float64)
    a1 = np.array([alpha_bar(x) for x in t / n_timestep])
    a2 = np.array([alpha_bar(x) for x in (t + 1) / n_timestep])
    return np.minimum(1.0 - a2 / a1, max_beta)


def _take(table: torch.Tensor, t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """table[t] on ref's device, shaped (B, 1, 1, ...) to broadcast against ref."""
    out = table.to(ref.device)[t.to(ref.device, torch.int64)]
    return out.reshape(out.shape + (1,) * (ref.ndim - out.ndim))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep tables (fp32, on the host) the samplers read, with the
    GLIDE posterior tables; `timestep_map` (int64) is arange(T) unless the
    schedule is respaced."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int

    @classmethod
    def from_betas(cls, betas: np.ndarray, v_posterior: float = 0.0,
                   timestep_map: Optional[np.ndarray] = None) -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        n = int(betas.shape[0])
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        pv = ((1 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac)
              + v_posterior * betas)
        # the t = 0 entry clipped to pv[1] (the GLIDE reference convention)
        plv = (np.log(np.append(pv[1], pv[1:])) if n > 1
               else np.log(np.maximum(pv, 1e-20)))
        if timestep_map is None:
            timestep_map = np.arange(n, dtype=np.int64)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
        return cls(betas=f32(betas), alphas_cumprod=f32(ac),
                   alphas_cumprod_prev=f32(ac_prev),
                   sqrt_alphas_cumprod=f32(np.sqrt(ac)),
                   sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
                   sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
                   sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
                   posterior_variance=f32(pv),
                   posterior_log_variance_clipped=f32(plv),
                   posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
                   posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
                   timestep_map=torch.as_tensor(np.asarray(timestep_map, dtype=np.int64)),
                   num_timesteps=n)

    @classmethod
    def create(cls, n_timestep: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2, schedule: str = "linear",
               cosine_s: float = 8e-3, v_posterior: float = 0.0) -> "DiffusionSchedule":
        """The JAX `create`'s keywords and defaults (positionally, the
        port's order: `n_timestep` first, as `make_beta_schedule`)."""
        betas = make_beta_schedule(n_timestep, linear_start, linear_end, schedule, cosine_s)
        return cls.from_betas(betas, v_posterior=v_posterior)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t (int, (B,)), fp32:
        sqrt(ac[t]) * x_start + sqrt(1 - ac[t]) * noise."""
        return (_take(self.sqrt_alphas_cumprod, t, x_start) * x_start.float()
                + _take(self.sqrt_one_minus_alphas_cumprod, t, x_start) * noise.float())

    def predict_xstart_from_eps(self, x_t: torch.Tensor, t: torch.Tensor,
                                eps: torch.Tensor) -> torch.Tensor:
        return (_take(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t.float()
                - _take(self.sqrt_recipm1_alphas_cumprod, t, x_t) * eps.float())

    def q_posterior_mean(self, x_start: torch.Tensor, x_t: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        return (_take(self.posterior_mean_coef1, t, x_t) * x_start.float()
                + _take(self.posterior_mean_coef2, t, x_t) * x_t.float())


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int = 1000,
                        method: str = "uniform") -> np.ndarray:
    """The DDIM timestep subset, int64 ascending, shifted by +1: "uniform"
    (range(0, T, T // S) + 1) or "quad" (linspace(0, sqrt(0.8 T), S)^2,
    truncated, + 1), the reference's `ddim_discretize`."""
    if not 1 <= num_ddim_timesteps <= num_ddpm_timesteps:
        raise ValueError(f"num_ddim_timesteps must be in [1, {num_ddpm_timesteps}],"
                         f" got {num_ddim_timesteps}")
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        if c == 1:
            # more than T/2 steps: an evenly spaced in-range subsequence
            return np.linspace(0, num_ddpm_timesteps - 1,
                               num_ddim_timesteps).round().astype(np.int64)
        return np.arange(num_ddim_timesteps, dtype=np.int64) * c + 1
    if method == "quad":
        return (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps)
                ** 2).astype(np.int64) + 1
    raise ValueError(f"unknown ddim discretization: {method!r}")


def ddim_sampling_parameters(alphas_cumprod, ddim_timesteps: np.ndarray,
                             eta: float = 0.0):
    """(sigmas, alphas, alphas_prev) for the chosen DDIM subset, float64."""
    alphas_cumprod = np.asarray(alphas_cumprod, dtype=np.float64)
    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.concatenate([[alphas_cumprod[0]],
                                  alphas_cumprod[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The original timesteps a respacing keeps: "ddimN" (an integer
    stride giving exactly N steps), "fast27" ("10,10,3,2,2" with the
    noisiest step swapped for T - 3), a comma string or a list of counts
    per equal section (each section's steps evenly spread, rounded)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} ddim steps "
                             "with an integer stride")
        if section_counts == "fast27":
            steps = space_timesteps(num_timesteps, "10,10,3,2,2")
            steps.remove(num_timesteps - 1)
            steps.add(num_timesteps - 3)
            return steps
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def respace_schedule(base_betas: np.ndarray,
                     use_timesteps: Union[Set[int], Sequence[int]],
                     v_posterior: float = 0.0) -> DiffusionSchedule:
    """The schedule over the kept original timesteps, with betas chosen so
    the respaced chain has the original alpha-bar at each of them."""
    alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, dtype=np.float64))
    last, new_betas, tmap = 1.0, [], []
    for t in sorted(int(t) for t in set(use_timesteps)):
        new_betas.append(1.0 - alphas_cumprod[t] / last)
        last = alphas_cumprod[t]
        tmap.append(t)
    return DiffusionSchedule.from_betas(np.array(new_betas), v_posterior=v_posterior,
                                        timestep_map=np.array(tmap, dtype=np.int64))
