"""Fused LayerNorm -> GEGLU feed-forward -> residual: the hand-written Hopper
kernel K5 and its plain version.

Port of benchmarks/research/fused_ff.py `fused_ln_geglu_ff`:
y = x + (a * gelu_tanh(g)) W2 + b2 with [a || g] = LN(x) W1 + b1, the third
sub-block of every SD transformer block, `x + ff(norm3(x))`
(models/attention.BasicTransformerBlock). CUDA source csrc/fused_ff.cu.

Weights come in the port's torch layouts: `w1` (2F, C) is
`GEGLU.proj.weight` (the JAX kernel's W1 (C, 2F) transposed, value half
first), `w2` (C, F) is `ff.net.2.weight`. Like the JAX kernel, the LN
weight and bias, b1 and b2 are cast to x's dtype first (the JAX
`_ff_reference` keeps them fp32; the plain version here follows the
kernel), the variance is E[x^2] - mu^2, and the GELU is the tanh form.

Forward only, as in the JAX package: the wrapper raises where autograd
would record. It runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. No path of the port calls it
(the JAX package retired its MDT_FUSE_FF hook); chip_smoke.py phase 18
holds it against the port's own `x + ff(norm3(x))` on real activations.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {
    "mdt_fused_ff": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
}
SLAB = 320        # output columns per block: C must be a multiple
MAX_C = 1280      # the normalised 64-row tile must fit shared memory
F_CHUNK = 32


def fused_ff_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's math in torch ops on x (B, N, C): LN in fp32 (E[x^2] -
    mu^2) with the affine params rounded to x's dtype, the normalised rows
    rounded to x's dtype, fp32-accumulated products of x-dtype operands,
    b1 and the tanh GELU in fp32, the GEGLU product rounded to x's dtype,
    b2 and the residual in fp32, one rounding to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    h = (x32 - mu) * torch.rsqrt(var + eps)
    h = h * ln_weight.to(dt).float() + ln_bias.to(dt).float()
    g = torch.matmul(h.to(dt).float(), w1.to(dt).float().T) + b1.to(dt).float()
    a, gate = g.chunk(2, dim=-1)
    u = a * F.gelu(gate, approximate="tanh")
    y = torch.matmul(u.to(dt).float(), w2.to(dt).float().T) + b2.to(dt).float()
    return (x32 + y).to(dt)


def block_args(block) -> tuple:
    """(ln_weight, ln_bias, w1, b1, w2, b2, eps) of a BasicTransformerBlock's
    norm3 and ff."""
    proj, out = block.ff.net[0].proj, block.ff.net[2]
    return (block.norm3.weight, block.norm3.bias, proj.weight, proj.bias,
            out.weight, out.bias, block.norm3.eps)


def fused_ln_geglu_ff(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (B, N, C) -> x + FF_geglu(LN(x)), (B, N, C) in x's dtype; w1 (2F, C),
    w2 (C, F). Counts its kernel launches in `fused_ln_geglu_ff.launches`."""
    args = (x, ln_weight, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("fused_ln_geglu_ff is forward only (no VJP, as in the "
                           "JAX package): call it under torch.no_grad()")
    if x.device.type == "cpu":
        return fused_ff_plain(x, ln_weight, ln_bias, w1, b1, w2, b2, eps)
    b, n, c = x.shape
    f = w2.shape[1]
    shapes = {"ln_weight": (c,), "ln_bias": (c,), "w1": (2 * f, c), "b1": (2 * f,),
              "w2": (c, f), "b2": (c,)}
    for name, t in zip(shapes, args[1:]):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes CUDA bfloat16 x, got {x.dtype} on {x.device}")
    if c % SLAB or c > MAX_C or f % F_CHUNK or x.numel() == 0:
        raise ValueError(f"kernel takes C a multiple of {SLAB} up to {MAX_C} and F a "
                         f"multiple of {F_CHUNK}; got C={c}, F={f}")
    x = x.contiguous()
    ln_w, ln_b, w1b, b1b, w2b, b2b = (t.to(torch.bfloat16).contiguous() for t in args[1:])
    out = torch.empty_like(x)
    lib = _build.load("fused_ff", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_fused_ff(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                               w1b.data_ptr(), b1b.data_ptr(), w2b.data_ptr(),
                               b2b.data_ptr(), out.data_ptr(), b * n, c, f,
                               float(eps), stream)
    _build.check(err, "fused_ff launch")
    fused_ln_geglu_ff.launches += 1
    return out


fused_ln_geglu_ff.launches = 0
