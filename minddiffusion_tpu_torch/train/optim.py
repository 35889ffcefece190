"""AdamW with decay and trainable masks and global-norm clipping (port of
minddiffusion_tpu/train/optim.py `build_optimizer`: optax.multi_transform of
clip_by_global_norm + adamw over the trainable leaves, set_to_zero over the
frozen ones).

Parameters are named by their LDM state-dict names (io/sd_weights.PREFIXES
+ the module's own name), the names the JAX masks map to through
`state_dict_from_jax`:
  * trainable ("unet": the UNet's params; "lora": every `lora_a` / `lora_b`;
    "all"; "unet+text");
  * weight decay: the JAX mask drops paths with "bias", "scale", "norm" or
    "embedding" and keeps ndim >= 2. Every bias and norm param of the port is
    1-D, so the same set is: ndim >= 2 and no "embedding" in the name.

The update is optax's, run by torch.optim.AdamW(fused=True) on the device
with no host sync (decoupled decay, eps outside the sqrt, as optax.adamw):
  g <- g if ||g|| < max_norm else g * max_norm / ||g||   (trainable g only)
  p <- p - lr(count) * (adam(g) + wd * p [decay set only]),  count += 1
`step(grads, finite)` applies it only where `finite` (a 0-d bool tensor) is
true: otherwise torch's `found_inf` leaves the params, both moments and
torch's step count as they were, and `count`, which the schedule reads,
stays too (the JAX step's finite guard). With `finite=None` every step
applies, as a bare optax chain does.

Under fsdp the params and their gradients are FSDP2's DTensor shards: the
fused update steps each rank's shards, and the clip reads the norm of the
whole gradient (parallel/collectives.global_norm sums the shards' squares
over their ranks), so every rank clips by the same factor. Under tp the
same: each rank steps its tp pieces and the params whole on every tp rank
(whose gradients are the same on each), and the norm sums a piece's
squares over the tp ranks (`tp`, the placement's record).

SD's configuration is the default (betas 0.9 / 0.98, wd 1e-6 on the decay
set, the trainable mask, the guard). GLIDE's chain,
optax.chain(clip_by_global_norm(1.0), adamw(lr)) (minddiffusion_tpu/cli/
glide_train.py:104), is `AdamW(params, lr, **GLIDE_ADAMW)` stepped with no
`finite`: every param trainable and decayed, betas 0.9 / 0.999, eps 1e-8,
wd 1e-4.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Set

import torch
from torch import nn

from minddiffusion_tpu_torch.io.sd_weights import PREFIXES
from minddiffusion_tpu_torch.parallel.collectives import global_norm

TRAINABLE_MODES = ("unet", "lora", "all", "unet+text")
# optax.adamw's defaults over every param (the GLIDE train CLI)
GLIDE_ADAMW = dict(weight_decay=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                   max_grad_norm=1.0, trainable=None)


def named_parameters(modules: Dict[str, nn.Module]) -> Dict[str, nn.Parameter]:
    """{LDM name: parameter} of {"unet": ..., "vae": ..., "text": ...}."""
    return {PREFIXES[kind] + name: p for kind, m in modules.items()
            for name, p in m.named_parameters()}


def trainable_names(names: Iterable[str], mode: str = "unet") -> Set[str]:
    """The names whose params receive updates (JAX `trainable_mask`)."""
    if mode not in TRAINABLE_MODES:
        raise ValueError(f"unknown trainable mode: {mode!r}")
    unet, text = PREFIXES["unet"], PREFIXES["text"]

    def keep(n: str) -> bool:
        if mode == "all":
            return True
        if mode == "unet":
            return n.startswith(unet)
        if mode == "lora":
            return "lora_" in n
        return n.startswith((unet, text))

    return {n for n in names if keep(n)}


def decay_names(params: Dict[str, torch.Tensor]) -> Set[str]:
    """The names weight decay applies to (JAX `decay_mask`)."""
    return {n for n, p in params.items() if p.ndim >= 2 and "embedding" not in n}


class AdamW:
    """The JAX optimizer over `params` (LDM name -> parameter): a fused
    torch AdamW over the trainable ones (two groups: decay and no decay),
    its lr a device tensor set from the schedule at `count`, the number of
    updates applied. `trainable` None: every param trainable and decayed
    (no mask, as a bare optax.adamw)."""

    def __init__(self, params: Dict[str, nn.Parameter], learning_rate: Callable,
                 weight_decay: float = 1e-6, beta1: float = 0.9, beta2: float = 0.98,
                 eps: float = 1e-8, max_grad_norm: float = 1.0,
                 trainable: Optional[str] = "unet", tp=None):
        self.trainable = sorted(params if trainable is None
                                else trainable_names(params, trainable))
        if not self.trainable:
            raise ValueError(f"no parameter is trainable under {trainable!r}")
        self.params = {n: params[n] for n in self.trainable}
        decay = set(self.params) if trainable is None else decay_names(self.params)
        self.schedule, self.max_norm, self.tp = learning_rate, max_grad_norm, tp
        device = next(iter(self.params.values())).device
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        groups = [{"params": [p for n, p in self.params.items() if (n in decay) == d],
                   "weight_decay": weight_decay if d else 0.0} for d in (True, False)]
        self.torch_optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=self.lr, betas=(beta1, beta2),
            eps=eps, fused=True)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from `grads` (name -> gradient of every trainable name;
        the trainable ones are clipped in place). Returns the global norm of
        the trainable gradients before the clip."""
        gs = []
        for p, g in zip(self.params.values(), (grads[n] for n in self.trainable)):
            # the fused update walks a gradient in its param's memory order
            p.grad = g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
            gs.append(p.grad)
        g_norm = global_norm(gs, self.tp, self.trainable)
        torch._foreach_mul_(gs, torch.where(g_norm < self.max_norm, 1.0,
                                            self.max_norm / g_norm))
        self.lr.copy_(self.schedule(self.count))
        opt = self.torch_optimizer
        if finite is not None:
            opt.found_inf = (~finite).float()   # the attribute GradScaler sets
        try:
            opt.step()
        finally:
            opt.__dict__.pop("found_inf", None)
            opt.zero_grad(set_to_none=True)
        self.count += 1 if finite is None else finite.to(torch.int64)
        return g_norm


def lora_checkpoint_transform(names: Iterable[str]) -> Callable:
    """state dict -> its adapter-only part, for `Trainer(ckpt_transform=...)`:
    the mask comes from `trainable_names(..., "lora")` once, so the saved
    set cannot drift from what the optimizer steps."""
    from minddiffusion_tpu_torch.io.checkpoints import trainable_only

    keep = trainable_names(names, "lora")
    return lambda state_dict: trainable_only(state_dict, keep)

