"""3x3 stride-1 same-pad convolution as an implicit GEMM: the hand-written
Hopper kernel K7 (its two TPU variants) and their plain versions.

Ports of benchmarks/research/conv3x3.py, NHWC activations, HWIO weights
(3, 3, C_in, C_out), fp32 accumulation:
  * `conv3x3_pallas` (v1, pallas_call :90): the nine shifted-window products
    summed in fp32, plus bias, out in x's dtype;
  * `conv3x3_gemm` (v2, pallas_call :286): the same conv of an optionally
    transformed input, y = conv(P(x)) + bias [+ residual] in `out_dtype`,
    where P(x) = [silu](x * prologue_scale + prologue_shift) per (batch,
    channel) runs in fp32 on the image and rounds to x's dtype, the zero
    padding staying zero; bias and residual add in fp32.
`groupnorm_affine_fold` gives the (scale, shift) that folds a GroupNorm into
v2's prologue, as in the JAX module.

Both wrappers launch the one GEMM kernel of csrc/conv3x3.cu on CUDA tensors
(bf16 x, C_in and C_out multiples of 8; v1 is its case with no prologue,
no residual and bf16 out; a prologue runs first as an elementwise pass
into a scratch image) on the block plan `conv3x3_plan` gives, and raise on
inputs it does not take; on CPU tensors they run their plain versions. The
TPU tiling options (`block_rows`, `block_cout`, `interpret`) do not change
the result and have no counterpart here. The weights go to the kernel as
they are laid out, HWIO, in bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {
    "mdt_conv3x3_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2,
}
SMEM_MAX = 232448        # a block's shared memory on the H100
SMEM_SLACK = 1024        # the rings' alignment
CLUSTER = 2              # CTAs along the pixels that share each weight tile
MAX_A_STAGES, MAX_B_STAGES = 3, 8


class ConvPlan(NamedTuple):
    """K7's launch: boxes of tw x th pixels of one image (64 per consumer
    warpgroup), bn output channels, wgs consumer warpgroups, a_stages pixel
    boxes and b_stages weight tiles in the rings, `ctas` CTAs (pairs along
    the pixels), `smem` bytes of shared memory a CTA."""
    tw: int
    th: int
    bn: int
    wgs: int
    a_stages: int
    b_stages: int
    ctas: int
    smem: int


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b: int, h: int, w: int, c_in: int, c_out: int) -> ConvPlan:
    """The block plan of csrc/conv3x3.cu at (B, H, W, C_in, C_out). The
    block comes from H, W and C_out alone (B only counts the CTAs), and the
    kernel sums each output in the same order in any block, so a batch
    row's result does not depend on the batch:
      * boxes 16 pixels wide (W > 8) or 8, 64 / tw rows a consumer
        warpgroup; a pixel box, loaded once for each dx, serves its three
        dy taps, so its rows (tw x 128 bytes) are whole swizzle atoms;
      * BN: of 128 and 256 the width that pads C_out least (ties: 256);
        128 where H*W <= 256, which doubles the CTAs of the UNet's 16^2 and
        8^2 levels;
      * one consumer warpgroup where H*W <= 64 (two CTAs an SM), else two;
      * three pixel boxes in their ring, and as many weight tiles as the
        rest of shared memory holds (per CTA: all of it, or half with one
        consumer warpgroup), at most MAX_B_STAGES.
    The CTAs run in pairs (clusters) along the pixels: each loads half of
    every weight tile for both, so the grid is padded to whole pairs."""
    if min(b, h, w, c_in, c_out) < 1:
        raise ValueError(f"no plan for an empty conv {(b, h, w, c_in, c_out)}")
    tw = 16 if w > 8 else 8
    wgs = 1 if h * w <= 64 else 2
    th = 64 * wgs // tw
    if h * w <= 256:
        bn = 128
    else:
        bn = min((256, 128), key=lambda n: -(-c_out // n) * n)
    a_bytes, b_bytes = tw * (th + 2) * 128, bn * 128
    budget = (SMEM_MAX if wgs == 2 else SMEM_MAX // 2 - 1024) - SMEM_SLACK
    a_stages = MAX_A_STAGES
    b_stages = min(MAX_B_STAGES, (budget - a_stages * (a_bytes + 16)) // (b_bytes + 16))
    boxes = -(-w // tw) * -(-h // th) * b
    ctas = -(-boxes // CLUSTER) * CLUSTER * -(-c_out // bn)
    smem = SMEM_SLACK + a_stages * (a_bytes + 16) + b_stages * (b_bytes + 16)
    return ConvPlan(tw, th, bn, wgs, a_stages, b_stages, ctas, smem)


last_ctas = {"conv3x3": 0}   # the GEMM's CTAs at the last launch, as the launcher reports


def _bias(bias: Optional[torch.Tensor], c_out: int, device) -> torch.Tensor:
    if bias is None:
        return torch.zeros(c_out, dtype=torch.float32, device=device)
    return bias.float()


def conv3x3_pallas_plain(x: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v1's math in torch ops: the kernel rounded to x's dtype, the nine
    shifted (B, H, W, C_in) @ (C_in, C_out) products summed in fp32, plus
    the fp32 bias, out in x's dtype."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    k = kernel.to(x.dtype).float()
    acc = sum(torch.matmul(xp[:, dy:dy + h, dx:dx + w], k[dy, dx])
              for dy in range(3) for dx in range(3))
    return (acc + _bias(bias, kernel.shape[-1], x.device)).to(x.dtype)


def _prologue(x: torch.Tensor, scale: Optional[torch.Tensor],
              shift: Optional[torch.Tensor], silu: bool) -> torch.Tensor:
    """[silu](x * scale + shift) in fp32, rounded to x's dtype (x itself
    when there is nothing to apply)."""
    if scale is None and not silu:
        return x
    xf = x.float()
    if scale is not None:
        xf = xf * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
    if silu:
        xf = torch.sigmoid(xf) * xf
    return xf.to(x.dtype)


def conv3x3_gemm_plain(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       prologue_scale: Optional[torch.Tensor] = None,
                       prologue_shift: Optional[torch.Tensor] = None,
                       silu_prologue: bool = False,
                       residual: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """v2's math in torch ops: the prologue on the image (the padding is
    added after it, so it stays zero), the three dy taps stacked along K,
    one fp32 product per dx over the padded width, the dx shift resolved on
    the fp32 outputs, then bias and residual in fp32."""
    if (prologue_scale is None) != (prologue_shift is None):
        raise ValueError("prologue_scale and prologue_shift go together")
    b, h, w, c_in = x.shape
    xp = F.pad(_prologue(x, prologue_scale, prologue_shift, silu_prologue),
               (0, 0, 1, 1, 1, 1)).float()
    r = torch.cat([xp[:, dy:dy + h] for dy in range(3)], dim=-1)   # (B, H, W+2, 3 C_in)
    k = kernel.to(x.dtype).float()
    acc = sum(torch.matmul(r, k[:, dx].reshape(3 * c_in, -1))[:, :, dx:dx + w]
              for dx in range(3))
    acc = acc + _bias(bias, kernel.shape[-1], x.device)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype or x.dtype)


def groupnorm_affine_fold(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          num_groups: int = 32, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (scale, shift), each (B, C) fp32, with GroupNorm(x) * gamma
    + beta == x * scale + shift (fp32 statistics of NHWC x; the group count
    falls to the largest divisor of C not above `num_groups`)."""
    b, h, w, c = x.shape
    groups = num_groups
    while c % groups:
        groups -= 1
    xg = x.float().reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = xg.var(dim=(1, 3), unbiased=False)
    inv = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)
    mean = mean.repeat_interleave(c // groups, dim=1)
    a = gamma.float()[None, :] * inv
    return a, beta.float()[None, :] - mean * a


def _kernel_operands(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor]):
    """Check what the kernel takes; the HWIO weights and the bias as the
    kernel reads them: bf16 and fp32, contiguous on x's device."""
    b, h, w, c_in = x.shape
    c_out = kernel.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"the kernel takes contiguous CUDA bf16 NHWC x, got {x.dtype} "
                         f"on {x.device}")
    if tuple(kernel.shape) != (3, 3, c_in, c_out) or c_in % 8 or c_out % 8:
        raise ValueError(f"the kernel takes HWIO (3, 3, C_in, C_out) weights with C_in, "
                         f"C_out % 8 == 0; got {tuple(kernel.shape)} for x "
                         f"{tuple(x.shape)}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    return kernel.to(torch.bfloat16).contiguous(), _bias(bias, c_out, x.device).contiguous()


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
            prologue_scale: Optional[torch.Tensor] = None,
            prologue_shift: Optional[torch.Tensor] = None, silu_prologue: bool = False,
            residual: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One launch of csrc/conv3x3.cu (both wrappers' kernel; v1 is its case
    with no prologue, no residual and bf16 out)."""
    b, h, w, c_in = x.shape
    wt, bias32 = _kernel_operands(x, kernel, bias)
    c_out = wt.shape[-1]
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel writes bf16 or fp32, not {out_dtype}")
    scale = shift = None
    if prologue_scale is not None:
        scale, shift = (t.to(x.device, torch.float32).contiguous()
                        for t in (prologue_scale, prologue_shift))
        if scale.shape != (b, c_in) or shift.shape != (b, c_in):
            raise ValueError(f"the prologue takes (B, C_in) = {(b, c_in)} scale and shift")
    if residual is not None:
        if (residual.shape != (b, h, w, c_out) or residual.dtype != torch.bfloat16
                or residual.device != x.device or not residual.is_contiguous()):
            raise ValueError(f"residual must be contiguous bf16 {(b, h, w, c_out)} on "
                             f"{x.device}")
    out = torch.empty((b, h, w, c_out), dtype=out_dtype, device=x.device)
    # the prologue's image, which the GEMM then reads
    pbuf = torch.empty_like(x) if scale is not None or silu_prologue else None
    plan = conv3x3_plan(b, h, w, c_in, c_out)
    ctas = ctypes.c_int(0)
    lib = _build.load("conv3x3", _SIGNATURES)
    with _build.on_device(x.device):
        err = lib.mdt_conv3x3_gemm(
            x.data_ptr(), wt.data_ptr(), bias32.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), int(silu_prologue),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), None if pbuf is None else pbuf.data_ptr(),
            b, h, w, c_in, c_out, plan.tw, plan.bn, plan.wgs, plan.a_stages, plan.b_stages,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(ctas))
    _build.check(err, "conv3x3 launch")
    last_ctas["conv3x3"] = ctas.value
    return out


def conv3x3_pallas(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 v1: x (B, H, W, C_in), kernel (3, 3, C_in, C_out), bias (C_out,)
    -> (B, H, W, C_out) in x's dtype. Counts its kernel launches in
    `conv3x3_pallas.launches`."""
    if x.device.type == "cpu":
        return conv3x3_pallas_plain(x, kernel, bias)
    out = _launch(x, kernel, bias)
    conv3x3_pallas.launches += 1
    return out


conv3x3_pallas.launches = 0


def conv3x3_gemm(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 prologue_scale: Optional[torch.Tensor] = None,
                 prologue_shift: Optional[torch.Tensor] = None,
                 silu_prologue: bool = False,
                 residual: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K7 v2: y = conv([silu](x * prologue_scale + prologue_shift)) + bias
    [+ residual], prologue_scale / prologue_shift (B, C_in), residual
    (B, H, W, C_out), out in `out_dtype` (default x's; the kernel writes bf16
    or fp32). Counts its kernel launches in `conv3x3_gemm.launches`."""
    if (prologue_scale is None) != (prologue_shift is None):
        raise ValueError("prologue_scale and prologue_shift go together")
    if x.device.type == "cpu":
        return conv3x3_gemm_plain(
            x, kernel, bias, prologue_scale=prologue_scale, prologue_shift=prologue_shift,
            silu_prologue=silu_prologue, residual=residual, out_dtype=out_dtype)
    out = _launch(x, kernel, bias, prologue_scale, prologue_shift, silu_prologue, residual,
                  out_dtype)
    conv3x3_gemm.launches += 1
    return out


conv3x3_gemm.launches = 0
