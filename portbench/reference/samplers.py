"""Plain float64 reference of the sampler arithmetic the benchmark's
generation cells run: the SD "linear" schedule, classifier-free guidance,
the DDIM update (Song et al., arXiv:2010.02502, LDM's table conventions)
and the DPM-Solver++ 2M update (Lu et al., arXiv:2211.01095, the
multistep solver of the LDM / DPM-Solver reference code: time-uniform
nodes on the discrete-time schedule, lower order at the first step and,
below 15 steps, at the last).

`steps(...)` gives, for a sampler run, the model time of each evaluation
and a function that takes one update from the state and the model outputs
it has seen, so the check can follow the program step by step.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def alphas_cumprod(timesteps: int, linear_start: float, linear_end: float) -> np.ndarray:
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def guide(eps2: torch.Tensor, scale: float) -> torch.Tensor:
    """[uncond; cond] model outputs -> uncond + scale (cond - uncond)."""
    u, c = eps2.double().chunk(2, dim=0)
    return u + scale * (c - u)


def _ddim(ac: np.ndarray, num_steps: int):
    c = len(ac) // num_steps
    ts = np.arange(num_steps, dtype=np.int64) * c + 1
    alphas = ac[ts]
    alphas_prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
    t = ts[::-1]
    a, ap = alphas[::-1], alphas_prev[::-1]
    times = [float(x) for x in t]

    def update(i: int, x: torch.Tensor, eps: List[torch.Tensor]) -> torch.Tensor:
        e = eps[i]
        x0 = (x.double() - np.sqrt(1.0 - a[i]) * e) / np.sqrt(a[i])
        return np.sqrt(ap[i]) * x0 + np.sqrt(max(1.0 - ap[i], 0.0)) * e

    return times, update


def _dpm2m(ac: np.ndarray, steps: int):
    n = len(ac)
    t_disc = np.arange(1, n + 1, dtype=np.float64) / n
    log_alpha = 0.5 * np.log(ac)
    t_nodes = np.linspace(1.0, 1.0 / n, steps + 1)
    la = np.interp(t_nodes, t_disc, log_alpha)
    alpha = np.exp(la)
    sigma = np.sqrt(np.maximum(1.0 - np.exp(2.0 * la), 1e-20))
    lam = la - np.log(sigma)
    # the model times as the solver hands them over: fp32
    times = [float(np.float32(x)) for x in (t_nodes - 1.0 / n) * 1000.0][:steps]
    h = lam[1:] - lam[:-1]
    order = np.minimum(2, np.arange(1, steps + 1))
    if steps < 15:
        order = np.minimum(order, steps - np.arange(1, steps + 1) + 1)

    def data_pred(k: int, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        return (x.double() - sigma[k] * e) / alpha[k]

    def update(i: int, x: torch.Tensor, eps: List[torch.Tensor], xs: List[torch.Tensor]
               ) -> torch.Tensor:
        """x_{i+1} from x_i = xs[i] and the guided outputs at nodes i, i-1."""
        m0 = data_pred(i, xs[i], eps[i])
        phi = np.expm1(-h[i])
        out = sigma[i + 1] / sigma[i] * x.double() - alpha[i + 1] * phi * m0
        if order[i] >= 2:
            m1 = data_pred(i - 1, xs[i - 1], eps[i - 1])
            r0 = h[i - 1] / h[i]
            out = out - 0.5 * alpha[i + 1] * phi * (m0 - m1) / r0
        return out

    return times, update


def steps(sampler: str, num_steps: int, timesteps: int, linear_start: float,
          linear_end: float) -> Tuple[List[float], Callable]:
    """(model time of each evaluation, update(i, xs, eps) -> x_{i+1}), where
    xs[j] is the state the j-th evaluation saw and eps[j] its guided output
    (float64)."""
    ac = alphas_cumprod(timesteps, linear_start, linear_end)
    if sampler == "ddim":
        times, upd = _ddim(ac, num_steps)
        return times, lambda i, xs, eps: upd(i, xs[i], eps)
    if sampler == "dpm":
        times, upd = _dpm2m(ac, num_steps)
        return times, lambda i, xs, eps: upd(i, xs[i], eps, xs)
    raise ValueError(f"no reference for sampler {sampler!r}")
