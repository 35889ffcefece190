"""Shared building blocks (port of minddiffusion_tpu/models/layers.py).

Activations are NHWC at every public function, as in the JAX package;
convolutions run NCHW internally. Norms compute in fp32 and return the
input dtype. `conv3x3_dispatch` sends a 3x3 stride-1 conv to a Winograd
kernel at the gated shapes (ops/winograd.wino_route) and to F.conv2d
otherwise: K2 by default, K3 (the gathered-tile kernel) under
MDT_WINO_TUNE=dma=0, as the JAX package's `dma` flag does. A GroupNorm+SiLU
folded to a per-(batch, channel) affine (`gn=(mult, add)`) runs as K2's
prologue, on the host before K3's gather, elementwise elsewhere. Where
autograd records (grad enabled, and x, the weight, the bias or the GN
affine requiring grad) a gated conv takes the JAX package's training route
(minddiffusion_tpu/models/layers.py:262-281): GN+SiLU elementwise in fp32,
rounded to the activation dtype, then the kernel without its prologue and
without a cached U, differentiated through the direct conv
(ops/winograd.conv3x3_winograd_ad).

Every layer computes in its input's dtype and casts its weights to it at
use (`Linear`, the convs), so fp32 master weights run bf16 compute, as the
JAX package's modules do with dtype=bf16, param_dtype=fp32.

`hoisted` opens the caches of one sampling run: the Winograd transform U of
each gated conv and, through `reuse`, the cross-attention K/V of a constant
context (models/attention.CrossAttention, models/glide.GlideAttentionBlock).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple, TypeVar

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch import ops
from minddiffusion_tpu_torch.ops import winograd
from minddiffusion_tpu_torch.utils.flags import flags


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, fp32, ordered [cos || sin] like the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def gn_groups(channels: int, num_groups: int = 32) -> int:
    """The largest divisor of `channels` not above `num_groups`."""
    groups = num_groups
    while channels % groups:
        groups -= 1
    return groups


def gn_affine_from_sums(s1: torch.Tensor, s2: torch.Tensor, n_spatial: int,
                        scale: torch.Tensor, bias: torch.Tensor,
                        num_groups: int = 32, eps: float = 1e-5,
                        emb: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm folded to a per-(batch, channel) affine from per-channel
    fp32 spatial sums (s1, s2): GroupNorm(x) * scale + bias == x * mult + add.

    `emb` (B or 1, C): a pre-norm add folded analytically, so that
    GroupNorm(x + emb) * scale + bias == x * mult + add without forming
    x + emb (the moments shift by s1' = s1 + n e, s2' = s2 + 2 e s1 + n e^2)."""
    c = s1.shape[-1]
    groups = gn_groups(c, num_groups)
    gs = c // groups
    if emb is not None:
        e = emb.float()
        s2 = s2 + 2.0 * e * s1 + n_spatial * e * e
        s1 = s1 + n_spatial * e
    b = s1.shape[0]
    n = n_spatial * gs
    mu_g = s1.reshape(b, groups, gs).sum(-1) / n
    ex2_g = s2.reshape(b, groups, gs).sum(-1) / n
    inv_g = torch.rsqrt(ex2_g - mu_g * mu_g + eps)
    mu_c = mu_g.repeat_interleave(gs, dim=-1)
    inv_c = inv_g.repeat_interleave(gs, dim=-1)
    mult = inv_c * scale.float()[None]
    add = bias.float()[None] - mu_c * mult
    if emb is not None:
        add = add + emb.float() * mult
    return mult, add


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics; output in the input dtype. NHWC."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = gn_groups(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    @staticmethod
    def stat_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel fp32 spatial sums (sum x, sum x^2), each (B, C), of
        NHWC x: the statistics every GroupNorm affine is built from (the
        quantities the channel-sums kernel K6 computes, ops/gn_stats.py)."""
        x32 = x.float()
        return x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))

    def affine(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This norm as a (mult, add) affine of x (see gn_affine_from_sums)."""
        s1, s2 = self.stat_sums(x)
        return gn_affine_from_sums(s1, s2, x.shape[1] * x.shape[2], self.weight,
                                   self.bias, self.num_groups, self.eps, emb)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype: the weight (and bias) are
    cast to it at use, as flax's Dense casts its fp32 params to `dtype`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32; output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _gn_silu(x: torch.Tensor, gn: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """silu(x * mult + add) in fp32, rounded to x's dtype."""
    xf = x.float() * gn[0][:, None, None, :] + gn[1][:, None, None, :]
    return F.silu(xf).to(x.dtype)


def conv3x3_dispatch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     gn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     u_cache: Optional[dict] = None) -> torch.Tensor:
    """3x3 stride-1 same-pad conv of NHWC `x` with OIHW `weight`.

    `gn` = (mult, add), each (B, C_in) fp32: the conv input becomes
    silu(x * mult + add). `u_cache`: a dict that keeps the Winograd
    transform of `weight` (key "u") from one call to the next; without it
    the transform is computed on every Winograd-routed call; either kernel
    takes the same U. Under `ops.plain_reference()` the Winograd route runs
    the kernel's plain version."""
    _, h, w, c_in = x.shape
    if winograd.wino_route(h, w, c_in):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, weight, bias, *(gn or ()))):
            # the training route (module docstring)
            if gn is not None:
                x = _gn_silu(x, gn)
            gathered = not flags().wino_dma
            if ops.plain_active():
                u = winograd.transform_weights(weight.to(x.dtype).permute(2, 3, 1, 0))
                plain = winograd.winograd_gathered_plain if gathered else winograd.winograd_plain
                return plain(x, u.to(x.dtype), bias)
            return winograd.conv3x3_winograd_ad(x, weight, bias, gathered)
        u = None if u_cache is None else u_cache.get("u")
        if u is None:
            u = winograd.transform_weights(weight.permute(2, 3, 1, 0)).to(x.dtype).contiguous()
            if u_cache is not None:
                u_cache["u"] = u
        mult, add = gn if gn is not None else (None, None)
        if not flags().wino_dma:        # MDT_WINO_TUNE=dma=0: the gather path, K3
            if ops.plain_active():
                return winograd.winograd_gathered_plain(x, u, bias, mult, add)
            return winograd.conv3x3_winograd_gathered(x, u, bias.float(), mult, add)
        if ops.plain_active():
            return winograd.winograd_plain(x, u, bias, mult, add)
        return winograd.conv3x3_winograd(x.contiguous(), u, bias.float(), mult, add)
    if gn is not None:
        x = _gn_silu(x, gn)
    return conv3x3_nhwc(x, weight, bias)


class Conv3x3(nn.Module):
    """3x3 conv on NHWC with LDM {weight (O, I, 3, 3), bias} params.

    Stride 1 goes through `conv3x3_dispatch`; `wino_cache` is a dict that
    keeps the Winograd transform while a pipeline call runs (models/unet.py
    `hoisted_winograd`), None otherwise. Stride 2 takes `pad` = (left,
    right, top, bottom) zero padding and runs `conv3x3_nhwc`."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 pad: Tuple[int, int, int, int] = (1, 1, 1, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.stride = stride
        self.pad = pad
        self.wino_cache: Optional[dict] = None

    def forward(self, x: torch.Tensor,
                gn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        if self.stride == 1:
            return conv3x3_dispatch(x, self.weight, self.bias, gn, self.wino_cache)
        if gn is not None:
            raise ValueError("the GN prologue is for stride-1 convs")
        return conv3x3_nhwc(x, self.weight, self.bias, self.stride, self.pad)


# Output pixels (B * Ho * Wo) up to which a 3x3 conv on a CUDA tensor runs
# as `patch_gemm_conv3x3` instead of cuDNN's conv.
PATCH_GEMM_MAX_ROWS = 4096


def conv3x3_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 stride: int = 1, pad: Tuple[int, int, int, int] = (1, 1, 1, 1)
                 ) -> torch.Tensor:
    """NHWC 3x3 conv at `stride` after zero padding `pad` = (left, right,
    top, bottom), in x's dtype: F.conv2d, or on the card `patch_gemm_conv3x3`
    where the output has at most PATCH_GEMM_MAX_ROWS pixels.

    cuDNN's bf16 conv on the H100 gives an image results that depend on its
    position in the batch at the UNet's small-spatial sites ((16, 8, 8,
    1280 or 2560) -> 1280 and (16, 16, 16, 1280) at stride 1, (16, 32, 32,
    640) at stride 2: a reduction split by output position), which breaks
    the serving engine's per-request determinism. The patch product takes
    the same reduction for every pixel; at the larger outputs cuDNN's conv
    keeps an image's result to itself (both measured on the card at the SD2
    shapes; chip_smoke.py phase 25 holds the served images bytewise)."""
    left, right, top, bottom = pad
    ho = (x.shape[1] + top + bottom - 3) // stride + 1
    wo = (x.shape[2] + left + right - 3) // stride + 1
    if x.is_cuda and x.shape[0] * ho * wo <= PATCH_GEMM_MAX_ROWS:
        return patch_gemm_conv3x3(x, weight, bias, stride, pad)
    xc, w, b = x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype)
    if stride == 1 and pad == (1, 1, 1, 1):
        y = F.conv2d(xc, w, b, padding=1)
    else:
        y = F.conv2d(F.pad(xc, pad), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def patch_gemm_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       stride: int, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """`conv3x3_nhwc` as the gathered patches (B, Ho, Wo, 9 C_in) times the
    (9 C_in, C_out) weight in one matrix product."""
    left, right, top, bottom = pad
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    ho = (xp.shape[1] - 3) // stride + 1
    wo = (xp.shape[2] - 3) // stride + 1
    cols = torch.cat([xp[:, di:di + stride * (ho - 1) + 1:stride,
                         dj:dj + stride * (wo - 1) + 1:stride]
                      for di in range(3) for dj in range(3)], dim=-1)
    w = weight.to(x.dtype).permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    return F.linear(cols, w, bias.to(x.dtype))


class Conv1x1(nn.Module):
    """1x1 conv on NHWC (a per-pixel linear map) with LDM (O, I, 1, 1) weights."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        lin = nn.Linear(in_ch, out_ch)
        self.weight = nn.Parameter(lin.weight.detach()[:, :, None, None].clone())
        self.bias = nn.Parameter(lin.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), self.bias.to(x.dtype))


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 average pool, stride 2 (flax `nn.avg_pool`, VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


T = TypeVar("T")


def reuse(cache: Optional[dict], key: torch.Tensor, compute: Callable[[], T]) -> T:
    """compute(); or, while a `hoisted` scope holds `cache` (a dict), the
    value last computed in the scope for this very tensor `key`. The key is
    the tensor object, held by the cache, so no other tensor can take its
    id while the entry lives and no device value is read. A call with
    another tensor computes anew and replaces the entry; where autograd
    records, nothing is reused. A key changed in place inside the scope is
    not seen: the pipelines' contexts are not."""
    if cache is None or torch.is_grad_enabled():
        return compute()
    if cache.get("key") is not key:
        cache["key"], cache["value"] = key, compute()
    return cache["value"]


@contextlib.contextmanager
def hoisted(module: nn.Module, wino: bool = True, kv: bool = True):
    """For one sampling run, keep from its first call on the Winograd
    transform U of every Winograd-routed stride-1 conv of `module` (`wino`)
    and the value each module with a `kv_cache` computes from a constant
    tensor (`kv`: the cross-attention K/V, `reuse`), instead of computing
    them at every step. The caches are emptied when the scope ends."""
    sites = [(m, "wino_cache") for m in module.modules()
             if wino and isinstance(m, Conv3x3) and m.stride == 1]
    sites += [(m, "kv_cache") for m in module.modules() if kv and hasattr(m, "kv_cache")]
    for m, attr in sites:
        setattr(m, attr, {})
    try:
        yield
    finally:
        for m, attr in sites:
            setattr(m, attr, None)


def hoisted_winograd(module: nn.Module):
    """`hoisted` for the Winograd transforms alone."""
    return hoisted(module, wino=True, kv=False)


def cast_for_inference(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every weight in `dtype` except the norms' affine params, which
    stay fp32 (norms compute in fp32, as in the JAX package)."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (GroupNorm32, LayerNormFp32)):
            m.float()
    return module
