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

Both wrappers launch the one kernel of csrc/conv3x3.cu on CUDA tensors
(bf16 x, C_in and C_out multiples of 8; v1 is its case with no prologue,
no residual and bf16 out) and raise on inputs it does not take; on CPU tensors
they run their plain versions. The TPU tiling options (`block_rows`,
`block_cout`, `interpret`) do not change the result and have no
counterpart here. The weights go to the kernel as (9, C_out, C_in) bf16.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import _build

_SIGNATURES = {
    "mdt_conv3x3_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


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
    """Check what the kernel takes; the weights as (9, C_out, C_in) bf16 and
    the bias as fp32, both contiguous on x's device."""
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
    wt = kernel.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9, c_out, c_in).contiguous()
    return wt, _bias(bias, c_out, x.device).contiguous()


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
            prologue_scale: Optional[torch.Tensor] = None,
            prologue_shift: Optional[torch.Tensor] = None, silu_prologue: bool = False,
            residual: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One launch of csrc/conv3x3.cu (both wrappers' kernel; v1 is its case
    with no prologue, no residual and bf16 out)."""
    b, h, w, c_in = x.shape
    wt, bias32 = _kernel_operands(x, kernel, bias)
    c_out = wt.shape[1]
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
    lib = _build.load("conv3x3", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.mdt_conv3x3_gemm(
            x.data_ptr(), wt.data_ptr(), bias32.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), int(silu_prologue),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), b, h, w, c_in, c_out,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3 launch")
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
