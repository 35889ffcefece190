"""Per-channel spatial sums for GroupNorm statistics: the hand-written Hopper
kernel K6 and its plain version.

Port of benchmarks/research/gn_stats.py `channel_sums` with its two Pallas
kernels, `channel_sums_pallas` (a (B, H, W, C) activation) and
`channel_sums_pallas_t` (the same logical tensor read in the memory order
(H, W, B, C)): s1 = sum over (H, W) of x, s2 = sum of x^2, each (B, C) fp32.
CUDA source csrc/gn_stats.cu; one kernel takes both memory orders as
strides. These are the sums `models.layers.GroupNorm32.affine` builds every
GroupNorm from (`GroupNorm32.stat_sums`). No path of the port calls it: the
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
from typing import Tuple

import torch

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {
    "mdt_channel_sums": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p],
}
SLAB_ROWS = 256   # spatial rows a block reduces (csrc/gn_stats.cu)


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
    if x.dim() != 4 or x.shape[-1] % 2 or x.numel() == 0:
        raise ValueError(f"kernel takes non-empty (B, H, W, C) with C even; got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    batch_stride, row_stride = _strides(x, transposed)
    n_slabs = -(-(h * w) // SLAB_ROWS)
    part = torch.empty((2, b * n_slabs * c), dtype=torch.float32, device=x.device)
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    lib = _build.load("gn_stats", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_channel_sums(x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                                   s1.data_ptr(), s2.data_ptr(), b, h * w, c,
                                   batch_stride, row_stride, n_slabs, stream)
    _build.check(err, "channel_sums launch")
    channel_sums.launches += 1
    return s1, s2


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
    read). Counts its kernel launches in `channel_sums.launches` (one per
    call: the slab partials and their sum are two kernels of one call)."""
    return _ChannelSumsFn.apply(x, transposed)


channel_sums.launches = 0
