"""Attention dispatch: plain torch attention + the two attention kernels.

Port of minddiffusion_tpu/ops/attention.py, with the reference's full route:

  * `packed_attention` on (B, N, C = heads * D) sends a site to the packed
    kernel K1 (`flash_attention_packed`) in the caller's softmax mode when
    `packed_route` takes it: nq >= 1024, nk >= 512 (both `min_q` where the
    caller gives it), nk % 128 == 0 and the reference's VMEM footprint rule
    (with the caller's `block_q` hint where it fits). Every other site goes
    to `dot_product_attention`, in exact mode also under attn_impl="fast".
  * `dot_product_attention` on (B, N, H, D) sends a site with no bias,
    nq >= 1024 and nk >= 512 to the head-split kernel K4 (`flash_attention`)
    in exact mode; every other site runs `einsum_attention`.

The footprint rule is a TPU budget (12 MiB of VMEM for double-buffered K/V
and the q/out tiles); it is kept because it is the reference's route, so
each site runs the counterpart of the kernel the reference runs there, in
the same softmax mode. Re-deriving the route from H100 timings is queued
work (ROADMAP S4).

Each kernel's wrapper launches its kernel on CUDA tensors (or raises on
inputs it does not take) and runs its plain version on CPU tensors; under
`ops.plain_reference()` a kernel site runs the plain version directly.

attn_impl: None (exact softmax at the kernel sites) or "fast" (raw-exp
softmax at the K1 sites, valid below logit 88).
"""
from __future__ import annotations

from typing import Optional

import torch

from minddiffusion_tpu_torch import ops
from minddiffusion_tpu_torch.ops import flash_attention

MIN_Q_TOKENS = 1024
MIN_K_TOKENS = 512
PACKED_VMEM_BUDGET = 12 * 1024 * 1024
SCORE_TILE_BUDGET = 6 * 1024 * 1024


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D) in q's dtype:
    fp32 scores (+ additive fp32 bias), fp32 softmax, probabilities rounded
    to v's dtype, fp32 PV."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qh = q.transpose(1, 2).float()                     # (B, H, Nq, D)
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vh)
    return out.transpose(1, 2).to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D): K4 in exact mode
    where there is no bias, nq >= 1024 and nk >= 512; einsum otherwise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is None and q.shape[1] >= MIN_Q_TOKENS and k.shape[1] >= MIN_K_TOKENS:
        if ops.plain_active():
            return flash_attention.flash_attention_plain(q, k, v, scale)
        return flash_attention.flash_attention(q.contiguous(), k.contiguous(),
                                               v.contiguous(), scale)
    return einsum_attention(q, k, v, scale=scale, bias=bias)


def packed_route(nq: int, nk: int, c: int, block_q: Optional[int] = None,
                 min_q: Optional[int] = None) -> bool:
    """Whether the reference sends a packed site to K1: the token gates
    (`min_q` replaces both the 1024 on nq and the 512 on nk), then the
    footprint rule nk*C*2*2 + bq*C*6 <= 12 MiB (K/V double-buffered in
    bf16, q/out tiles), with bq = 256 when a 256 x nk fp32 score tile fits
    6 MiB, else 128. The hint `block_q`, rounded down to a multiple of 128
    and cut to nq, replaces bq when it divides nq and its bq x nk fp32
    score tile fits 6 MiB (JAX `ops/attention.py` `packed_attention`).
    The kernel tiles q its own way; bq only enters the rule."""
    gate_q = min_q if min_q is not None else MIN_Q_TOKENS
    gate_k = min_q if min_q is not None else MIN_K_TOKENS
    if nq < gate_q or nk < gate_k or nk % 128:
        return False
    bq = 256 if 256 * nk * 4 <= SCORE_TILE_BUDGET else 128
    if block_q:
        cand = min(block_q - block_q % 128, nq)
        if cand >= 128 and nq % cand == 0 and cand * nk * 4 <= SCORE_TILE_BUDGET:
            bq = cand
    return nk * c * 2 * 2 + bq * c * 6 <= PACKED_VMEM_BUDGET


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: Optional[float] = None,
                     impl: Optional[str] = None, block_q: Optional[int] = None,
                     min_q: Optional[int] = None) -> torch.Tensor:
    """Attention on packed (B, N, C) tensors along the reference's route
    (`block_q`, `min_q`: the route hints of `packed_route`)."""
    if impl not in (None, "fast"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    if packed_route(nq, nk, c, block_q, min_q):
        exact = impl != "fast"
        if ops.plain_active():
            return flash_attention.packed_attention_plain(q, k, v, heads, scale,
                                                          exact=exact)
        return flash_attention.flash_attention_packed(
            q.contiguous(), k.contiguous(), v.contiguous(), heads, scale,
            exact=exact)
    out = dot_product_attention(q.reshape(b, nq, heads, d),
                                k.reshape(b, nk, heads, d),
                                v.reshape(b, nk, heads, d), scale=scale)
    return out.reshape(b, nq, c)
