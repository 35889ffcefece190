"""The lower-precision control of the comparison: the reference with both
operands of every product rounded to float8 (e4m3, one scale per tensor,
its largest magnitude at 448), the step below the bfloat16 the
configurations state; where autograd records, the gradient reaching each
operand is rounded the same way. A sound check reads it as not correct."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def _round(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8_e4m3fn at a per-tensor scale, in float32."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Fp8.apply(x)
    return _round(x)
