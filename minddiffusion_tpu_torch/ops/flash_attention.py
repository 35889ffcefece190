"""Fused attention: the two hand-written Hopper kernels and their plain versions.

Ports of minddiffusion_tpu/ops/flash_attention.py:
  * `flash_attention_packed` (`_packed_kernel`, K1): softmax(scale * Q K^T) V
    on packed (B, N, C = heads * D) tensors, head h being the column slice
    [h*D, (h+1)*D), any Nq, Nk >= 1. CUDA source csrc/packed_attention.cu
    (the attention core csrc/attn_core.cuh at D 40 / 64 / 80 / 160, its own
    kernel at D 512 with one head), launched as `packed_plan` says.
  * `flash_attention` (`_flash_bhnd` / `_attn_kernel`, K4): the same on
    head-split (B, N, H, D) tensors with any Nq, Nk, in exact (online max)
    or static-shift (exp(s - 20)) softmax. CUDA source
    csrc/flash_attention.cu.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises. The launch runs inside a
`torch.autograd.Function` whose backward recomputes
`ops.attention.einsum_attention` from the saved q, k, v and differentiates
that, as the JAX package's `custom_vjp`s `_packed_ad` / `_flash_ad` do
(minddiffusion_tpu/ops/attention.py:98-158): the kernels have no backward,
and none is launched in the backward pass.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from minddiffusion_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (40, 64, 80, 160, 512)   # SD1 8-head widths, SD2, the VAE
# K1's shared memory on the H100: a block's opt-in maximum, the alignment
# and barrier slack, at most 8 ring stages (csrc/attn_core.cuh)
SMEM_MAX, SMEM_SLACK, MAX_STAGES = 232448, 1024 + 512, 8
H100_SMS = 132

_SIGNATURES = {   # ends with the stream and an int* that receives the CTAs launched
    "mdt_packed_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2,
}
last_ctas: dict = {}   # CTAs of the last K1 launch, as its C entry reports them
_FLASH_SIGNATURES = {
    "mdt_flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
FAST_SHIFT = 20.0   # static softmax shift of exact_softmax=False (`_FAST_SHIFT`)
PLAIN_SCORE_BYTES = 4 << 30   # fp32 scores one step of flash_attention_plain holds


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, scale: float,
                           exact: bool = True) -> torch.Tensor:
    """The kernel's math in torch ops: q scaled in fp32 and rounded to its
    dtype, fp32 scores, fp32 softmax numerators (`exact`: minus the row max;
    otherwise raw exp, valid below logit 88), P rounded to v's dtype before
    PV, fp32 PV accumulation, division by the fp32 row sum.

    Runs one batch element at a time so the (heads, Nq, Nk) fp32 score
    tensor stays bounded at the card's shapes."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    out = torch.empty_like(q)
    for i in range(b):
        qi = (q[i].float() * scale).to(q.dtype).float()
        qi = qi.reshape(nq, heads, d).transpose(0, 1)          # (H, Nq, D)
        ki = k[i].float().reshape(nk, heads, d).transpose(0, 1)
        vi = v[i].float().reshape(nk, heads, d).transpose(0, 1)
        s = torch.matmul(qi, ki.transpose(1, 2))               # (H, Nq, Nk)
        if exact:
            s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(v.dtype).float(), vi)
        out[i] = (acc / l).transpose(0, 1).reshape(nq, c).to(q.dtype)
    return out


def ring_stages(c: int, d: int, rows: int, key_tile: int, stage: "int | None" = None) -> int:
    """Stages of the attention core's ring that fit beside a rows x C q / o
    tile, at most 8; under 2, the CTA does not fit. A stage is `stage`
    bytes, K1's by default: a K and a V tile, ceil(DK / 64) + ceil(D / 64)
    64-column boxes of a key tile (DK = D rounded up to 16)."""
    if stage is None:
        dk = -(-d // 16) * 16
        stage = (-(-dk // 64) + -(-d // 64)) * key_tile * 128
    return min(MAX_STAGES, (SMEM_MAX - SMEM_SLACK - -(-c // 64) * rows * 128) // stage)


def _tile_plan(nq: int, c: int, d: int, stage: "int | None",
               max_rows: int) -> "tuple[int, int, int]":
    """(rows, keys a tile, stages) of the attention core's CTA over C columns
    at head dim d, at most `max_rows` rows."""
    if d == 64 and c <= 448 and nq >= 2048:
        rows = 192
    elif d in (40, 64, 80) and c <= 640:
        rows = 128
    else:
        rows = 64
    rows = min(rows, max_rows)
    key_tile = 32 if d == 160 else 64
    return rows, key_tile, ring_stages(c, d, rows, key_tile, stage)


@functools.lru_cache(maxsize=None)
def packed_plan(nq: int, c: int, heads: int, batch: int = 1, sms: int = H100_SMS,
                stage: "int | None" = None,
                max_rows: int = 192) -> "tuple[int, int, int, int] | None":
    """(q rows of a CTA, keys of a tile, ring stages, head groups) of K1's
    launch at (B, Nq, C, heads) on a card of `sms` SMs, or None where the
    kernel takes no such shape; with `stage` (and `max_rows`), of another
    kernel on the same core at D 64 whose ring stages are `stage` bytes
    (K12's modes, the ones kernels) and whose CTAs take at most `max_rows`
    rows.

    D 512 runs its own kernel, one head only: 64 rows, 64 keys, one stage.
    Else the attention core (csrc/attn_core.cuh) holds a q / o tile of
    rows x C' (C' = C / groups) and a ring of K / V stages (`ring_stages`):
    192 rows at D 64 up to C' 448 where Nq >= 2048, 128 at D 40 / 64 / 80
    up to C' 640, else 64; 32-key tiles at D 160, 64 else; at least 2
    stages. Groups: the fewest that give
    at least three quarters of a CTA an SM, among the splits of the heads
    whose C' is whole 64-column boxes (else the most such)."""
    if heads < 1 or c % heads or nq < 1 or batch < 1:
        return None
    d = c // heads
    if d not in KERNEL_HEAD_DIMS:
        return None
    if d == 512:
        return (64, 64, 1, 1) if heads == 1 else None
    plan = None
    for groups in range(1, heads + 1):
        if heads % groups or (groups > 1 and (c // groups) % 64):
            continue
        rows, key_tile, stages = _tile_plan(nq, c // groups, d, stage, max_rows)
        if stages < 2:
            continue
        plan = (rows, key_tile, stages, groups)
        if batch * -(-nq // rows) * groups * 4 >= 3 * sms:
            break
    return plan


@functools.lru_cache(maxsize=None)
def _sms(index: "int | None") -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_supports(q: torch.Tensor, k: torch.Tensor, heads: int) -> bool:
    """Shapes and dtype the CUDA kernel takes: any Nq, Nk >= 1 (keys and
    rows past the ends are TMA's zero fill) where `packed_plan` has a plan."""
    return (q.dtype == torch.bfloat16 and k.shape[1] >= 1
            and packed_plan(q.shape[1], q.shape[-1], heads, q.shape[0]) is not None)


def _einsum_vjp(q, k, v, g, scale: float, heads: int = 0):
    """Gradients of `einsum_attention` at (q, k, v) against the cotangent g;
    (B, N, C) packed tensors when `heads` is given, (B, N, H, D) otherwise."""
    from minddiffusion_tpu_torch.ops.attention import einsum_attention

    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        if heads:
            b, nq, c = q.shape
            split = [t.reshape(b, t.shape[1], heads, c // heads) for t in qkv]
            out = einsum_attention(*split, scale=scale).reshape(b, nq, c)
        else:
            out = einsum_attention(*qkv, scale=scale)
        return torch.autograd.grad(out, qkv, g)


class _PackedAttentionFn(torch.autograd.Function):
    """K1 forward, einsum-attention backward (JAX `_packed_ad`)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, exact):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return _packed_launch(q, k, v, heads, scale, exact)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_einsum_vjp(q, k, v, g.contiguous(), ctx.scale, ctx.heads),
                None, None, None)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, scale: float,
                           exact: bool = True) -> torch.Tensor:
    """q (B, Nq, C), k/v (B, Nk, C) -> (B, Nq, C). Counts its kernel launches
    in `flash_attention_packed.launches`; differentiable (module docstring)."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, heads, scale, exact)
    return _PackedAttentionFn.apply(q, k, v, heads, scale, exact)


def _packed_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, scale: float, exact: bool) -> torch.Tensor:
    b, nq, c = q.shape
    nk = k.shape[1]
    for name, t, shape in (("q", q, (b, nq, c)), ("k", k, (b, nk, c)),
                           ("v", v, (b, nk, c))):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned {shape}, "
                             f"got {tuple(t.shape)}")
    plan = packed_plan(nq, c, heads, b, _sms(q.device.index))
    if plan is None or nk < 1:
        raise ValueError(f"kernel takes head dim in {KERNEL_HEAD_DIMS} (D 512 "
                         f"with one head) and Nk >= 1; got C={c}, heads={heads}, "
                         f"Nk={nk}")
    rows, key_tile, stages, groups = plan
    out = torch.empty_like(q)
    lib = _build.load("packed_attention", _SIGNATURES)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_packed_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq,
            nk, c, heads, float(scale), int(exact), rows, key_tile, stages,
            groups, stream, ctypes.byref(ctas))
    _build.check(err, "packed_attention launch")
    last_ctas["mdt_packed_attention"] = ctas.value
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, exact_softmax: bool = True) -> torch.Tensor:
    """K4's math in torch ops on (B, N, H, D): q scaled in fp32 and rounded
    to its dtype, fp32 scores, fp32 numerators exp(s - row max) (exact) or
    exp(s - 20) (static shift), P rounded to v's dtype before PV, fp32 PV
    accumulation, division by the fp32 row sum of the unrounded P.

    Runs one batch element, and within it as many heads as keep the
    (heads, Nq, Nk) fp32 score tensor within PLAIN_SCORE_BYTES, at a time,
    so that it stays bounded at the card's shapes."""
    out = torch.empty_like(q)
    h, nq, nk = q.shape[2], q.shape[1], k.shape[1]
    hc = max(1, min(h, PLAIN_SCORE_BYTES // (4 * nq * nk)))
    for i in range(q.shape[0]):
        for h0 in range(0, h, hc):
            hs = slice(h0, h0 + hc)
            qi = (q[i, :, hs].float() * scale).to(q.dtype).float().transpose(0, 1)
            ki = k[i, :, hs].float().transpose(0, 1)           # (heads, Nk, D)
            vi = v[i, :, hs].float().transpose(0, 1)
            s = torch.matmul(qi, ki.transpose(1, 2))           # (heads, Nq, Nk)
            s = s - (s.amax(dim=-1, keepdim=True) if exact_softmax else FAST_SHIFT)
            p = torch.exp(s)
            l = p.sum(dim=-1, keepdim=True)
            acc = torch.matmul(p.to(v.dtype).float(), vi)
            out[i, :, hs] = (acc / l).transpose(0, 1).to(q.dtype)
    return out


FLASH_HEAD_DIMS = (40, 64, 80, 160, 512)


class _FlashAttentionFn(torch.autograd.Function):
    """K4 forward, einsum-attention backward (JAX `_flash_ad`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, exact_softmax):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _flash_launch(q, k, v, scale, exact_softmax)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_einsum_vjp(q, k, v, g.contiguous(), ctx.scale), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, exact_softmax: bool = True) -> torch.Tensor:
    """q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D); any Nq, Nk.
    Counts its kernel launches in `flash_attention.launches`; differentiable
    (module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, exact_softmax)
    return _FlashAttentionFn.apply(q, k, v, scale, exact_softmax)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, exact_softmax: bool) -> torch.Tensor:
    b, nq, h, d = q.shape
    nk = k.shape[1]
    for name, t, shape in (("q", q, (b, nq, h, d)), ("k", k, (b, nk, h, d)),
                           ("v", v, (b, nk, h, d))):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned {shape}, "
                             f"got {tuple(t.shape)}")
    if d not in FLASH_HEAD_DIMS or nq < 1 or nk < 1:
        raise ValueError(f"kernel takes head dim in {FLASH_HEAD_DIMS} and "
                         f"Nq, Nk >= 1; got D={d}, Nq={nq}, Nk={nk}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _FLASH_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk,
            h, d, float(scale), int(exact_softmax), stream)
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
