"""Winograd F(4x4, 3x3) convolution: the hand-written Hopper kernel K8, its
plain version and its gradient.

Port of benchmarks/research/winograd43.py: `conv3x3_winograd43` (pallas_call
:203), a 3x3 stride-1 same-pad conv of NHWC x (H, W multiples of 4) with
HWIO weights, computed as 36 products per 4x4 output tile against
U = G k G^T (`transform_weights43`, which the caller may hoist as `u`);
`conv3x3_winograd43_ad` with its direct-conv backward (`_wino43_bwd`,
:249-271), and the shape gate `wino43_wins` with its MDT_WINO43=0 switch.
No model path calls either, as in the JAX package.

  B^T = [[4,0,-5,0,1,0], [0,-4,-4,1,1,0], [0,4,-4,-1,1,0],
         [0,-2,-1,2,1,0], [0,2,-1,-2,1,0], [0,4,0,-5,0,1]]
  G   = [[1/4,0,0], [-1/6,-1/6,-1/6], [-1/6,1/6,-1/6],
         [1/24,1/12,1/6], [1/24,-1/12,1/6], [0,0,1]]
  A^T = [[1,1,1,1,1,0], [0,1,-1,2,-2,0], [0,1,1,4,4,0], [0,1,-1,8,-8,1]]

The wrapper launches csrc/winograd43.cu on CUDA tensors (bf16 x, C_in and
C_out multiples of 8): U^T and the input transform into bf16 scratch,
then one fused kernel for the 36 products and the output transform. It
raises on inputs the kernel does not take; on CPU tensors it runs the
plain version.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import _build
from minddiffusion_tpu_torch.ops.winograd import _direct_conv

_SIGNATURES = {
    "mdt_winograd43_conv3x3": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 2,
}
# csrc/winograd43.cu's constants: a CTA of the fused kernel takes TILES tiles
# x CHANNELS output channels through a ring of STAGES stages of 64 input
# channels (V: TILES rows, U^T: CHANNELS rows); the input transform works in
# items of IN_TILES tiles x 64 channels
TILES, CHANNELS, STAGES, CHUNK = 64, 32, 16, 64
IN_TILES = (2, 4)
SMEM_MAX = 232448
last_ctas = {"winograd43": 0}   # the fused kernel's CTAs at the last launch
_G = ((1 / 4, 0, 0), (-1 / 6, -1 / 6, -1 / 6), (-1 / 6, 1 / 6, -1 / 6),
      (1 / 24, 1 / 12, 1 / 6), (1 / 24, -1 / 12, 1 / 6), (0, 0, 1))


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def transform_weights43(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C_in, C_out) -> U (36, C_in, C_out) = G k G^T, fp32."""
    g = torch.tensor(_G, dtype=torch.float32, device=kernel.device)
    k = kernel.float()
    u = torch.einsum("ar,rsco->asco", g, k)
    u = torch.einsum("bs,asco->abco", g, u)
    return u.reshape(36, *kernel.shape[2:])


def wino43_wins(h: int, w: int, c_in: int, c_out: int) -> bool:
    """The JAX gate: H, W multiples of 4 and at least 128, C_in and C_out
    multiples of 128, the bf16 U at most 40 MiB; MDT_WINO43=0 turns it off."""
    if os.environ.get("MDT_WINO43", "1") == "0":
        return False
    weight_bytes = 36 * _round_up(c_in, 128) * c_out * 2
    return (h % 4 == 0 and w % 4 == 0 and min(h, w) >= 128
            and c_in % 128 == 0 and c_out % 128 == 0
            and weight_bytes <= 40 * 1024 * 1024)


def wino43_plan(b: int, h: int, w: int, c_in: int, c_out: int) -> dict:
    """K8's launch at (B, H, W, C_in, C_out): the fused kernel's block
    (tiles x channels, stages, shared memory a CTA, CTAs) and the input
    transform's work items (IN_TILES tiles x 64 channels each; its CTAs,
    two an SM, walk them); V's channels padded to cp, a multiple of 64.
    The block does not depend on B, so a batch row's result does not
    depend on the batch."""
    p = b * (h // 4) * (w // 4)
    cp = -(-c_in // CHUNK) * CHUNK
    stage = CHUNK * (TILES + CHANNELS) * 2
    in_items = -(-(w // 4) // IN_TILES[1]) * b * -(-(h // 4) // IN_TILES[0]) * (cp // CHUNK)
    return dict(tiles=TILES, channels=CHANNELS, stages=STAGES,
                smem=STAGES * (stage + 16) + 1024, ctas=-(-p // TILES) * -(-c_out // CHANNELS),
                in_items=in_items, cp=cp)


def _combine6(g):
    """B^T along a 6-slot axis given the slots g[0..5]."""
    return (4.0 * g[0] - 5.0 * g[2] + g[4],
            -4.0 * g[1] - 4.0 * g[2] + g[3] + g[4],
            4.0 * g[1] - 4.0 * g[2] - g[3] + g[4],
            -2.0 * g[1] - g[2] + 2.0 * g[3] + g[4],
            2.0 * g[1] - g[2] - 2.0 * g[3] + g[4],
            4.0 * g[1] - 5.0 * g[3] + g[5])


def _output4(m):
    """A^T along a 6-slot axis given m[0..5]."""
    return (m[0] + m[1] + m[2] + m[3] + m[4],
            m[1] - m[2] + 2.0 * m[3] - 2.0 * m[4],
            m[1] + m[2] + 4.0 * m[3] + 4.0 * m[4],
            m[1] - m[2] + 8.0 * m[3] - 8.0 * m[4] + m[5])


def conv3x3_winograd43_plain(x: torch.Tensor, kernel: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8's algorithm in torch ops: fp32 B^T on the 6x6 patches (columns,
    then rows), V rounded to x's dtype, the 36 fp32-accumulated products
    with U in x's dtype, fp32 A^T (rows, then columns) plus bias, out in
    x's dtype."""
    b, h, w, _ = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"F(4x4, 3x3) takes H, W % 4 == 0, got {h}x{w}")
    c_out = kernel.shape[-1]
    if u is None:
        u = transform_weights43(kernel)
    uf = u.to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    # d[i][j]: element (i, j) of every tile's patch, (B, H/4, W/4, C_in)
    d = [[xp[:, i:i + h:4, j:j + w:4] for j in range(6)] for i in range(6)]
    cols = [_combine6(row) for row in d]                      # cols[i][k]
    m = [[None] * 6 for _ in range(6)]
    for k in range(6):
        for a, v in enumerate(_combine6([cols[i][k] for i in range(6)])):
            m[a][k] = torch.matmul(v.to(x.dtype).float(), uf[6 * a + k])
    bias = torch.zeros(c_out, device=x.device) if bias is None else bias.float()
    rows = [_output4([m[a][k] for a in range(6)]) for k in range(6)]   # rows[k][i]
    y = torch.stack([torch.stack([o + bias for o in _output4([rows[k][i] for k in range(6)])],
                                 dim=3)
                     for i in range(4)], dim=2)     # (B, H/4, 4, W/4, 4, C_out)
    return y.reshape(b, h, w, c_out).to(x.dtype)


def conv3x3_winograd43(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: x (B, H, W, C_in), kernel (3, 3, C_in, C_out), bias (C_out,), u
    (36, C_in, C_out) the hoisted transform -> (B, H, W, C_out) in x's
    dtype. Counts its kernel launches in `conv3x3_winograd43.launches`."""
    if x.device.type == "cpu":
        return conv3x3_winograd43_plain(x, kernel, bias, u)
    b, h, w, c_in = x.shape
    c_out = kernel.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"the kernel takes contiguous CUDA bf16 NHWC x, got {x.dtype} "
                         f"on {x.device}")
    if h % 4 or w % 4 or c_in % 8 or c_out % 8 or tuple(kernel.shape) != (3, 3, c_in, c_out):
        raise ValueError(f"the kernel takes H, W % 4 == 0 and C_in, C_out % 8 == 0; got "
                         f"x {tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    if u is None:
        u = transform_weights43(kernel)
    if tuple(u.shape) != (36, c_in, c_out):
        raise ValueError(f"u must be (36, C_in, C_out) = {(36, c_in, c_out)}, got "
                         f"{tuple(u.shape)}")
    u = u.to(torch.bfloat16).contiguous()
    bias = (torch.zeros(c_out, device=x.device) if bias is None else bias.float()).contiguous()
    for name, t in (("u", u), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    p = b * (h // 4) * (w // 4)
    cp = -(-c_in // CHUNK) * CHUNK    # V's channels: the kernel zeroes those past C_in
    vbuf = torch.empty((36, p, cp), dtype=torch.bfloat16, device=x.device)
    ut = torch.empty((36, c_out, c_in), dtype=torch.bfloat16, device=x.device)  # U^T, K-major
    out = torch.empty((b, h, w, c_out), dtype=torch.bfloat16, device=x.device)
    ctas = ctypes.c_int(0)
    lib = _build.load("winograd43", _SIGNATURES)
    with _build.on_device(x.device):
        err = lib.mdt_winograd43_conv3x3(
            x.data_ptr(), u.data_ptr(), ut.data_ptr(), bias.data_ptr(), vbuf.data_ptr(),
            out.data_ptr(), b, h, w, c_in, c_out, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(ctas))
    _build.check(err, "winograd43 launch")
    last_ctas["winograd43"] = ctas.value
    conv3x3_winograd43.launches += 1
    return out


conv3x3_winograd43.launches = 0


class _Winograd43Fn(torch.autograd.Function):
    """K8 forward (the plain version on CPU tensors); the backward
    differentiates the same-dtype direct conv at the saved inputs
    (JAX `_wino43_bwd` through `_direct_ref`). No kernel runs backward."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel, bias)
        return conv3x3_winograd43(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, kernel, bias)]
            y = _direct_conv(leaves[0], leaves[1].permute(3, 2, 0, 1), leaves[2])
            return torch.autograd.grad(y, leaves, g.to(y.dtype))


def conv3x3_winograd43_ad(x: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """`conv3x3_winograd43` with the direct-conv backward: x NHWC, kernel
    HWIO (any float dtype, e.g. fp32 master weights), bias (C_out,)."""
    return _Winograd43Fn.apply(x.contiguous(), kernel, bias)
