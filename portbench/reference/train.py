"""Plain float32 reference of the latent-diffusion fine-tuning step: the
eps-MSE loss (LDM `p_losses`, "l_simple") of the UNet on a VAE posterior
sample, the gradient of the UNet's parameters, global-norm clipping and
AdamW with decoupled weight decay (Loshchilov and Hutter; torch's update,
bias-corrected moments, eps outside the root), under a linear warm-up.

The loss of a batch is the mean over its rows; `step` runs the rows one at
a time and adds their gradients, so that it fits beside nothing else.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import models as ref
from portbench.reference.samplers import alphas_cumprod


def lr_at(cfg: dict, count: int) -> float:
    """Linear warm-up 0 -> start_lr, then cosine decay to end_lr, at float32."""
    step = np.float32(count)
    if count < cfg["warmup_steps"]:
        return float(np.float32(cfg["start_lr"]) * step / np.float32(cfg["warmup_steps"]))
    frac = min(max(count / max(1.0, float(cfg["decay_steps"])), 0.0), 1.0)
    return float(np.float32(cfg["end_lr"] + 0.5 * (cfg["start_lr"] - cfg["end_lr"])
                            * (1 + math.cos(math.pi * frac))))


def decays(name: str, p: torch.Tensor) -> bool:
    return p.ndim >= 2 and "embedding" not in name


class Trainer:
    """The trainable UNet leaves (float32, LDM-named) and AdamW's state."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 quant: Optional[object] = None):
        self.config, self.q = config, quant
        pre = ref.PREFIX["unet"]
        self.frozen = {k: v.float() for k, v in params.items() if not k.startswith(pre)}
        self.leaves = {k: v.detach().float().clone().requires_grad_(True)
                       for k, v in params.items() if k.startswith(pre)}
        self.m = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.count = 0
        ac = alphas_cumprod(**{k: config["schedule"][k] for k in
                               ("timesteps", "linear_start", "linear_end")})
        self.sqrt_ac = torch.tensor(np.sqrt(ac), dtype=torch.float32)
        self.sqrt_1m = torch.tensor(np.sqrt(1.0 - ac), dtype=torch.float32)

    def loss_and_grads(self, image, tokens, draws) -> float:
        """The batch's loss; the UNet leaves' .grad hold its gradient."""
        cfg, q = self.config, self.q
        b = image.shape[0]
        for p in self.leaves.values():
            p.grad = None
        params = dict(self.frozen, **self.leaves)
        total = 0.0
        for r in range(b):
            with torch.no_grad():
                mom = ref.vae_encode(self.frozen, cfg["vae"], image[r:r + 1], q)
                eps = draws["enc_noise"][r:r + 1].float()
                z0 = cfg["scale_factor"] * ref.posterior_sample(mom, eps)
                ctx = ref.text_encoder(self.frozen, cfg["text"], tokens[r:r + 1], q)
            t = draws["t"][r:r + 1].long()
            noise = draws["noise"][r:r + 1].float()
            dev = z0.device
            x_t = (self.sqrt_ac.to(dev)[t].reshape(-1, 1, 1, 1) * z0
                   + self.sqrt_1m.to(dev)[t].reshape(-1, 1, 1, 1) * noise)
            eps = ref.unet(params, cfg["unet"], x_t, t, ctx, q)
            mse = torch.mean(torch.square(eps - noise)) / b
            mse.backward()
            total += float(mse.detach())
        return total

    @torch.no_grad()
    def update(self) -> Dict[str, torch.Tensor]:
        """Clip and apply one AdamW update; returns the clipped gradient."""
        tc = self.config["train"]
        grads = {k: p.grad for k, p in self.leaves.items()}
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
        factor = 1.0 if norm < tc["max_grad_norm"] else float(tc["max_grad_norm"] / norm)
        lr = lr_at(tc, self.count)
        b1, b2, eps = tc["beta1"], tc["beta2"], 1e-8
        t = self.count + 1
        clipped = {}
        for k, p in self.leaves.items():
            g = grads[k] * factor
            clipped[k] = g
            if decays(k, p):
                p.mul_(1.0 - lr * tc["weight_decay"])
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1.0 - b1 ** t))
            p.grad = None
        self.count += 1
        return clipped
