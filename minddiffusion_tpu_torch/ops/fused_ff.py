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
tensors it launches the kernels of `ff_plan` or raises. No path of the port
calls it (the JAX package retired its MDT_FUSE_FF hook); chip_smoke.py
phase 18 holds it against the port's own `x + ff(norm3(x))` on real
activations.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {   # the plan's regime, rows, fc, stages (2), cluster, smem and grids (3)
    "mdt_fused_ff": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
SMEM_MAX = 232448     # a block's shared memory on the H100
SMS = 132             # the H100's SMs, where no card is asked
MAX_C = 1280          # the LN pass's 5 chunks of 8 columns a lane
FUSED_C = 320         # the width whose 64 x C fp32 output tile one warpgroup holds
# csrc/fused_ff.cu's compile-time choices; its C entry refuses a plan that
# states other ones
F_ROWS, F_CHUNK, CLUSTER = 128, 32, 2
F_STAGES = 14
G_BM, UP_STAGES, DOWN_STAGES = 128, 4, 6
LN_THREADS = 256
KERNELS = {"F": ("ff_fused_kernel",), "H": ("ff_ln_kernel", "ff_up_kernel", "ff_down_kernel")}


class FFPlan(NamedTuple):
    """How csrc/fused_ff.cu computes one call. regime "F": one fused
    launch; "H": the LN pass, then U = GEGLU(h W1^T + b1) and y = x + U
    W2^T + b2 as two persistent GEMMs, U through HBM once. rows: rows of x
    a CTA (or a GEMM tile) takes; fc: U columns a chunk (F) or an up tile
    (H); stages: the ring's of each product launch; cluster: CTAs that
    share each weight tile; ctas: the grid of each launch, in order;
    waves: each product launch's CTAs (F) or tiles (H) over the SMs; smem:
    shared-memory bytes of a product CTA; launches: kernel launches a call;
    flops: the products' flops for each row of x over 6 C F (1.0: nothing
    recomputed, no column computed twice)."""
    regime: str
    rows: int
    fc: int
    stages: tuple
    cluster: int
    ctas: tuple
    waves: tuple
    smem: int
    launches: int
    flops: float


def ff_plan(m: int, c: int, f: int, sms: int = SMS) -> FFPlan:
    """The plan of csrc/fused_ff.cu for x (m, c), F = f, on `sms` SMs: "F"
    at C 320 (SD2's and Wukong's ds1), where one warpgroup keeps its 64 x C
    fp32 output tile in registers across all of F, else "H" (ds2, ds4 and
    the 8^2 mid block at C 640 and 1280). Raises ValueError for what the
    kernels do not take: C a multiple of 320 up to MAX_C, F a multiple of
    32, M >= 1."""
    if m < 1 or c % FUSED_C or not 0 < c <= MAX_C or f % 32 or f < 32:
        raise ValueError(f"kernel takes C a multiple of {FUSED_C} up to {MAX_C}, F a "
                         f"multiple of 32 and M >= 1; got M={m}, C={c}, F={f}")
    return _fused_plan(m, c, f, sms) if c == FUSED_C else _split_plan(m, c, f, sms)


def _fused_plan(m: int, c: int, f: int, sms: int) -> FFPlan:
    ctas = -(-m // (F_ROWS * CLUSTER)) * CLUSTER
    # first product 2 C x 2F, second 2 F x (two 160-column halves)
    flops = (2 * c * 2 * f + 2 * f * 2 * 160) / (6 * c * f)
    smem = 1024 + 5 * F_ROWS * 128 + F_STAGES * 10240 + 256   # the LN tile, the ring
    return FFPlan("F", F_ROWS, F_CHUNK, (F_STAGES,), CLUSTER, (ctas,), (ctas / sms,),
                  smem, 1, flops)


def _split_plan(m: int, c: int, f: int, sms: int) -> FFPlan:
    """Regime H, which `ff_plan` takes above C 320; it also runs at C 320
    (scripts/ff_ablate.py times it there against the fused plan)."""
    row_tiles = -(-m // G_BM)
    up_tiles, down_tiles = row_tiles * -(-f // 128), row_tiles * -(-c // 128)
    ln_ctas = min(-(-m // (LN_THREADS // 32)), 8 * sms)
    # up: 128 value and 128 gate columns a tile; down: 128-column tiles of C,
    # F in 64-deep chunks
    flops = (2 * c * 2 * -(-f // 128) * 128
             + 2 * -(-f // 64) * 64 * -(-c // 128) * 128) / (6 * c * f)
    # the ring's stages of A and B boxes, two 64 x 128 output tiles, barriers
    smem = max(1024 + UP_STAGES * 49152 + 2 * 16384 + 16 * UP_STAGES,
               1024 + DOWN_STAGES * 32768 + 2 * 16384 + 16 * DOWN_STAGES)
    return FFPlan("H", G_BM, 128, (UP_STAGES, DOWN_STAGES), 1,
                  (ln_ctas, min(up_tiles, sms), min(down_tiles, sms)),
                  (up_tiles / sms, down_tiles / sms), smem, 3, flops)


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
    w2 (C, F). On the card, the kernels of `ff_plan(B N, C, F)`. Counts its
    calls that launch kernels in `fused_ln_geglu_ff.launches`."""
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _launch(ff_plan(b * n, c, f, sms), *args, eps=eps)


def _launch(plan: FFPlan, x: torch.Tensor, *params, eps: float) -> torch.Tensor:
    """Runs `plan` on x (B, N, C) bf16 on the card and the LN / FF params
    (ln_weight, ln_bias, w1, b1, w2, b2), checked by the caller."""
    m, c, f = x.shape[0] * x.shape[1], x.shape[2], params[4].shape[1]
    x = x.contiguous()
    ln_w, ln_b, w1b, b1b, w2b, b2b = (t.to(torch.bfloat16).contiguous() for t in params)
    out = torch.empty_like(x)
    h = u = None
    if plan.regime == "H":   # the LN pass's rows and U, bf16
        h = torch.empty(m, c, dtype=torch.bfloat16, device=x.device)
        u = torch.empty(m, f, dtype=torch.bfloat16, device=x.device)
    stages = (*plan.stages, 0)[:2]   # F has one ring
    grids = (*plan.ctas, 0, 0)[:3]   # and one launch
    lib = _build.load("fused_ff", _SIGNATURES)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mdt_fused_ff(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                               w1b.data_ptr(), b1b.data_ptr(), w2b.data_ptr(),
                               b2b.data_ptr(), out.data_ptr(),
                               None if h is None else h.data_ptr(),
                               None if u is None else u.data_ptr(), m, c, f, float(eps),
                               0 if plan.regime == "F" else 1, plan.rows, plan.fc, *stages,
                               plan.cluster, plan.smem, *grids, stream)
    _build.check(err, "fused_ff launch")
    fused_ln_geglu_ff.launches += 1
    return out


fused_ln_geglu_ff.launches = 0
