"""Exponential moving average of params (port of
minddiffusion_tpu/train/ema.py; reference Taichu-GLIDE simple_nn.py:119-129
update_ema).

The EMA is a state dict (name -> tensor) beside the model's params, in the
params' dtype and on their device; `update_ema` is one multi-tensor pass
on the device, ema <- ema + (1 - decay) (p - ema), which is the JAX
package's decay * ema + (1 - decay) * p up to rounding.
"""
from __future__ import annotations

from typing import Dict

import torch


def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of every param, detached."""
    return {n: p.detach().clone() for n, p in params.items()}


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, for every name
    of `ema`."""
    torch._foreach_lerp_(list(ema.values()), [params[n].detach() for n in ema],
                         1.0 - decay)
