"""GLIDE training loss: eps-MSE + VLB with learned variance (port of
minddiffusion_tpu/train/glide_loss.py; reference Taichu-GLIDE losses.py:25-86
and model/train_model.py:74-106).

  * `normal_kl`, the tanh `approx_standard_normal_cdf` and
    `discretized_gaussian_log_likelihood` (bins of +-1/255 around x in
    [-1, 1], the edge bins open past +-0.999, probabilities clipped at
    1e-12 before the log);
  * `vb_term`: the per-sample VLB in bits, KL(q(x_{t-1} | x_t, x_0) || p)
    for t > 0 and the discretized NLL at t == 0; the mean path sees eps with
    its gradient stopped, so only the variance head v learns from it; the
    variance interpolates, in fp32, between the clipped posterior log
    variance and log(betas) of the fp32 table;
  * `glide_diffusion_loss`: q_sample -> model -> mean(w * (MSE(eps) + VLB)).
    The noise is an argument: the JAX function draws it from its key.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule, _take


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """log p(x) for images discretized to 255 bins, x in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def vb_term(schedule: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor,
            t: torch.Tensor, eps: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-sample VLB (bits per dim) of the learned-variance head."""
    min_log = _take(schedule.posterior_log_variance_clipped, t, x_t)
    max_log = _take(torch.log(schedule.betas), t, x_t)
    frac = (v.float() + 1.0) / 2.0
    model_log_var = frac * max_log + (1.0 - frac) * min_log
    pred_x0 = schedule.predict_xstart_from_eps(x_t, t, eps.detach()).clamp(-1.0, 1.0)
    model_mean = schedule.q_posterior_mean(pred_x0, x_t, t)
    true_mean = schedule.q_posterior_mean(x_start, x_t, t)
    kl = _mean_flat(normal_kl(true_mean, min_log, model_mean, model_log_var)) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(x_start.float(), model_mean,
                                               0.5 * model_log_var)
    nll = _mean_flat(nll) / math.log(2.0)
    return torch.where(t.to(kl.device) == 0, nll, kl)


def glide_diffusion_loss(
        model_fn: Callable, schedule: DiffusionSchedule, x_start: torch.Tensor,
        tokens: torch.Tensor, mask: torch.Tensor, t: torch.Tensor, weights: torch.Tensor,
        noise: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """model_fn(x_t, t, tokens, mask) -> (eps, v), each like x_start (B, H,
    W, 3) in [-1, 1]; t (B,) ints; weights (B,) the importance weights;
    noise like x_start. -> (loss, {"loss", "mse", "vlb"})."""
    x_t = schedule.q_sample(x_start, t, noise)
    eps, v = model_fn(x_t, t, tokens, mask)
    mse = _mean_flat(torch.square(eps.float() - noise.float()))
    vlb = vb_term(schedule, x_start, x_t, t, eps, v)
    loss = torch.mean(weights.float() * (mse + vlb))
    return loss, {"loss": loss, "mse": mse.mean(), "vlb": vlb.mean()}
