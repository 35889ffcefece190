"""Per-channel spatial sums for GroupNorm statistics: the hand-written Hopper
kernel K6 and its plain version.

Port of benchmarks/research/gn_stats.py `channel_sums` with its two Pallas
kernels, `channel_sums_pallas` (a (B, H, W, C) activation) and
`channel_sums_pallas_t` (the same logical tensor read in the memory order
(H, W, B, C)): s1 = sum over (H, W) of x, s2 = sum of x^2, each (B, C) fp32.
CUDA source csrc/gn_stats.cu: one launch takes both memory orders, as
`planes` matrices with contiguous columns, on the plan `stats_plan` gives
(16- or 4-byte loads, the slabs of a column block one cluster). These are
the sums `models.layers.GroupNorm32.affine` builds every GroupNorm from
(`GroupNorm32.stat_sums`). No path of the port calls it: the
JAX package removed its model hooks, so the kernel is held on the card
against those sums on real activations (chip_smoke.py phase 17).

`channel_sums` is a `torch.autograd.Function` with the JAX package's
analytic VJP: dx = g1 + 2 x g2 in fp32, cast to x's dtype
(gn_stats.py:175-206). It runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises. The JAX package's
`MIN_BYTES` / `stats_route` shape gate is a TPU gate on no path and is not
ported: the caller chooses the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {   # x, s, planes, rows, cols, the strides, then the plan
    "mdt_channel_sums": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
SMS = 132             # the H100's SMs, where no card is asked
# csrc/gn_stats.cu's compile-time choices; its C entry refuses a plan that
# states other ones
THREADS, COLS, UNROLL, MAX_CLUSTER = 256, 64, 4, 8
CTAS_PER_SM = 2048 // THREADS   # threads bound it: 4.5 KB of static shared memory a CTA
TARGET_CTAS_PER_SM = 4          # ~64 KB of loads in flight an SM at 16 KB a CTA


class StatsPlan(NamedTuple):
    """How csrc/gn_stats.cu reduces one call: `planes` matrices of `rows` x
    `cols` (B of (H W, C), or one of (H W, B C) for the transposed read).
    vec: bf16 values a load (8: 16-byte loads; 2: 4-byte loads, for rows
    that are not 16-byte aligned); cols_per_cta: the columns a CTA sums;
    cluster: the CTAs (slabs of rows) that share a column block, adding
    their partials through distributed shared memory in rank order;
    rows_per_cta: the rows of a slab; ctas; waves: CTAs over the SMs'
    resident slots; scratch: bytes of global scratch (none); smem: static
    shared bytes a CTA."""
    vec: int
    planes: int
    rows: int
    cols: int
    cols_per_cta: int
    cluster: int
    rows_per_cta: int
    ctas: int
    waves: float
    scratch: int
    smem: int


@functools.lru_cache(maxsize=256)
def stats_plan(shape, transposed: bool = False, sms: int = SMS,
               base_aligned: bool = True) -> StatsPlan:
    """The plan of csrc/gn_stats.cu for x of logical shape (B, H, W, C),
    read in (H, W, B, C) memory order when `transposed`, on `sms` SMs;
    `base_aligned`: x's first element is 16-byte aligned. Where there are
    fewer column blocks than two an SM, slabs split a column block's rows
    until about TARGET_CTAS_PER_SM CTAs an SM are resident, at most
    MAX_CLUSTER and no thinner than one unrolled step; else a CTA takes a
    whole column block (a cluster launch costs ~1.3 µs more on the device
    at (16, 16, 16, 1280), scripts/tail_ablate.py).
    Raises ValueError for what the kernel does not take (C odd, an empty
    tensor)."""
    b, h, w, c = (int(v) for v in shape)
    if c % 2 or min(b, h, w, c) < 1:
        raise ValueError(f"kernel takes non-empty (B, H, W, C) with C even; got {tuple(shape)}")
    planes, rows, cols = (1, h * w, b * c) if transposed else (b, h * w, c)
    vec = 8 if cols % 8 == 0 and base_aligned else 2
    step = THREADS // (COLS // vec) * UNROLL          # rows a CTA takes in one unrolled step
    blocks = -(-cols // COLS) * planes
    # enough column blocks to give each SM two: no cluster (a plain launch,
    # one CTA a column block)
    cluster = 1 if blocks >= 2 * sms else max(1, min(
        MAX_CLUSTER, -(-TARGET_CTAS_PER_SM * sms // blocks), -(-rows // step)))
    ctas = cluster * blocks
    smem = 4 * (THREADS // 32 * 2 * COLS + 2 * COLS)   # the warps' partials, the CTA's
    return StatsPlan(vec, planes, rows, cols, COLS, cluster, -(-rows // cluster), ctas,
                     ctas / (sms * CTAS_PER_SM), 0, smem)


def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (sum x, sum x^2) over H, W in fp32, each (B, C)."""
    x32 = x.float()
    return x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))


def _strides(x: torch.Tensor, transposed: bool) -> Tuple[int, int]:
    """(batch stride, spatial-row stride) in elements, or raise when x's
    memory is not the order the caller names."""
    b, h, w, c = x.shape
    if transposed:
        if not x.permute(1, 2, 0, 3).is_contiguous():
            raise ValueError("transposed=True takes a (B, H, W, C) view of "
                             "(H, W, B, C) memory")
        return c, b * c
    if not x.is_contiguous():
        raise ValueError("transposed=False takes contiguous (B, H, W, C) memory")
    return h * w * c, c


def _launch(x: torch.Tensor, transposed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"kernel takes (B, H, W, C); got {tuple(x.shape)}")
    _strides(x, transposed)
    if x.data_ptr() % 4:
        raise ValueError("kernel takes x 4-byte aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _run(x, stats_plan(x.shape, transposed, sms, x.data_ptr() % 16 == 0))


def _run(x: torch.Tensor, plan: StatsPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs `plan` on x (checked by the caller): s1 and s2 are the two
    halves of one allocation."""
    s = torch.empty((2, x.shape[0], x.shape[3]), dtype=torch.float32, device=x.device)
    lib = _build.load("gn_stats", _SIGNATURES)
    with _build.on_device(x.device):
        err = lib.mdt_channel_sums(x.data_ptr(), s.data_ptr(), plan.planes, plan.rows,
                                   plan.cols, plan.cols, plan.rows * plan.cols, plan.vec,
                                   plan.cols_per_cta, plan.cluster, plan.rows_per_cta,
                                   plan.ctas, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "channel_sums launch")
    channel_sums.launches += 1
    return s[0], s[1]


class _ChannelSumsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transposed):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return channel_sums_plain(x)
        return _launch(x, transposed)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if g1 is not None:
            dx = dx + g1.float()[:, None, None, :]
        if g2 is not None:
            dx = dx + 2.0 * x.float() * g2.float()[:, None, None, :]
        return dx.to(x.dtype), None


def channel_sums(x: torch.Tensor, transposed: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) -> (s1, s2), each fp32 (B, C). `transposed`: x is a
    view whose memory order is (H, W, B, C) (`channel_sums_pallas_t`'s
    read). Counts its kernel launches in `channel_sums.launches`."""
    return _ChannelSumsFn.apply(x, transposed)


channel_sums.launches = 0
