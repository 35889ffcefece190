"""Variants of the heads-packed attention kernel: hand-written Hopper
kernels behind five wrappers, each beside its plain version.

Ports of benchmarks/research/attn_variants.py (K10) and
benchmarks/bench_attention.py (K11), on packed (B, N, C = heads * D)
tensors, head h being the column slice [h*D, (h+1)*D):
  * `flash_attention_packed_ones` (K10a): V augmented per head to
    [v_h | 1 | 0 ...] (B, Nk, 2C), built here as the JAX function builds it
    outside its pallas_call, so the PV product also yields the row sum.
  * `flash_attention_packed_fold` (K10b): the same fold, the ones column
    built inside the kernel from plain V. D = 64 only.
  * `flash_attention_packed_proj` (K10c): to_out(attention(x Wq * scale,
    x Wk, x Wv)) + bo in two launches: one GEMM x @ [Wq * scale | Wk | Wv]
    into a (B N, 3C) workspace, then K10d's kernel on it at scale 1.
  * `flash_attention_packed_out` (K10d): attention(q, k, v) @ Wo + bo, the
    output projection in the epilogue; C_out may differ from C.
  * `ones_attention` (K11): K10a's function, a second entry point over its
    kernel (the TPU version leaves q unpadded; the result is the same).
CUDA source csrc/attn_variants.cu, every kernel wgmma fed by TMA: K10a,
K10b and K11 run the ones kernel, K1's attention core (csrc/attn_core.cuh)
with a PV product 8 columns wider whose ninth column sums P, launched as
`ones_plan` says; K10c and K10d the out kernel on the same core. Weights
are in the JAX layout, (C_in, C_out).

Softmax, as the TPU kernels have it: `exact` subtracts the row max; with
exact=False, K10a, K10b and K11 take exp(s - 20) and K10c, K10d raw exp(s),
which overflows fp32 above logit ~88. q is scaled in fp32 and rounded to its
dtype (K10c folds the scale into Wq in fp32 and rounds that); P is rounded
to V's dtype before PV. With the ones column the row sum is the sum of the
rounded P; K10c and K10d divide by the fp32 sum of the unrounded P, round
each head's output to V's dtype before the Wo product and add bo in fp32.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel (bf16, D = 64) or raises. No path of either package
calls them: chip_smoke.py phase 27 holds them against their plain versions.
Forward only, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from minddiffusion_tpu_torch.ops import _build, flash_attention as fa

FAST_SHIFT = 20.0      # `_FAST_SHIFT` of the exp(s - 20) variants
KERNEL_HEAD_DIM = 64
KERNEL_MAX_C = 1280    # the out kernel keeps its q tile (rows x C) in shared memory
# A ring stage of the ones kernel: a K tile and two V boxes of 64 keys (the
# head's 64 columns, then the ones column's box)
ONES_STAGE = 3 * 64 * KERNEL_HEAD_DIM * 2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {   # each entry ends with an int* that receives its launch's CTAs
    "mdt_attn_ones": [_P] * 4 + [_I] * 7 + [_F] + [_I] * 4 + [_P, _P],
    "mdt_attn_out": [_P] * 6 + [_I] * 7 + [_F, _I, _P, _P],
    "mdt_qkv_proj": [_P] * 5 + [_I] * 2 + [_P, _P],
}
last_ctas: dict[str, int] = {}   # CTAs of each entry's last launch, as its launcher reports
ONES_FROM_V, ONES_IN_KERNEL = 1, 2   # mdt_attn_ones' ones_mode


def augment_v(v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Nk, C) -> (B, Nk, 2C): per head [v_h | 1 | 0 ...] (2D columns)."""
    b, nk, c = v.shape
    d = c // heads
    vh = v.reshape(b, nk, heads, d)
    ones = torch.ones(b, nk, heads, 1, dtype=v.dtype, device=v.device)
    zeros = torch.zeros(b, nk, heads, d - 1, dtype=v.dtype, device=v.device)
    return torch.cat([vh, ones, zeros], dim=-1).reshape(b, nk, 2 * c)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, heads * w) -> (heads, N, w) in fp32."""
    return t.float().reshape(t.shape[0], heads, -1).transpose(0, 1)


def _numerators(s: torch.Tensor, exact: bool, shift: float) -> torch.Tensor:
    return torch.exp(s - (s.amax(dim=-1, keepdim=True) if exact else shift))


def attn_ones_plain(q: torch.Tensor, k: torch.Tensor, va: torch.Tensor, scale: float,
                    heads: int, exact: bool = True) -> torch.Tensor:
    """K10a's and K11's math on the augmented V `va` (B, Nk, 2C): fp32
    scores of the rounded scaled q, numerators exp(s - max) or exp(s - 20),
    [P V | l] = bf16(P) @ V' accumulated in fp32, out = (P V) / l. One batch
    element at a time, so the (heads, Nq, Nk) scores stay bounded."""
    b, nq, c = q.shape
    d = c // heads
    out = torch.empty_like(q)
    for i in range(b):
        qi = _heads((q[i].float() * scale).to(q.dtype), heads)
        s = torch.matmul(qi, _heads(k[i], heads).transpose(1, 2))
        p = _numerators(s, exact, FAST_SHIFT)
        acc = torch.matmul(p.to(va.dtype).float(), _heads(va[i], heads))   # (H, Nq, 2D)
        out[i] = (acc[..., :d] / acc[..., d:d + 1]).transpose(0, 1).reshape(nq, c).to(q.dtype)
    return out


def _attend_plain(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  exact: bool, dtype: torch.dtype) -> torch.Tensor:
    """(Nq, C) fp32 q (already scaled and rounded), k, v (Nk, C) -> the
    heads' outputs (Nq, C), each rounded to `dtype`: numerators exp(s - max)
    or raw exp(s), divided by their fp32 sum after bf16(P) @ V."""
    s = torch.matmul(_heads(qi, heads), _heads(k, heads).transpose(1, 2))
    p = _numerators(s, exact, 0.0)
    o = torch.matmul(p.to(dtype).float(), _heads(v, heads)) / p.sum(dim=-1, keepdim=True)
    return o.to(dtype).transpose(0, 1).reshape(qi.shape[0], -1)


def attn_out_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
                   bo: torch.Tensor, scale: float, heads: int,
                   exact: bool = True) -> torch.Tensor:
    """K10d's math: the heads' outputs (rounded to v's dtype) @ Wo (rounded
    to q's dtype), accumulated in fp32, + bo in fp32, rounded once."""
    dt = q.dtype
    wo32 = wo.to(dt).float()
    out = torch.empty(q.shape[0], q.shape[1], wo.shape[1], dtype=dt, device=q.device)
    for i in range(q.shape[0]):
        qi = (q[i].float() * scale).to(dt)
        o = _attend_plain(qi, k[i], v[i], heads, exact, v.dtype)
        out[i] = (torch.matmul(o.float(), wo32) + bo.float()).to(dt)
    return out


def attn_proj_plain(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, scale: float,
                    heads: int, exact: bool = True) -> torch.Tensor:
    """K10c's math: Wq * scale in fp32 rounded to x's dtype; q, K', V' the
    fp32 products of x with the rounded weights, rounded to x's dtype; then
    K10d's attention and epilogue on them (without a second scale)."""
    dt = x.dtype
    wqs = (wq.float() * scale).to(dt)
    out = torch.empty_like(x)
    for i in range(x.shape[0]):
        xi = x[i].float()
        qi, ki, vi = (torch.matmul(xi, w.to(dt).float()).to(dt) for w in (wqs, wk, wv))
        o = _attend_plain(qi, ki, vi, heads, exact, dt)
        out[i] = (torch.matmul(o.float(), wo.to(dt).float()) + bo.float()).to(dt)
    return out


def _check(what: str, device: torch.device, tensors: dict, heads: int, c: int) -> None:
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} must be on {device}, got {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if c % heads or c // heads != KERNEL_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HEAD_DIM}, got "
                         f"C={c}, heads={heads}")


def _bf16(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bfloat16, got {t.dtype}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(entry: str, *args) -> int:
    """Calls the C entry `entry` (builds the library) and keeps the CTAs it
    launched in `last_ctas`; returns its error code."""
    ctas = ctypes.c_int(0)
    err = getattr(_build.load("attn_variants", _SIGNATURES), entry)(*args, ctypes.byref(ctas))
    last_ctas[entry] = ctas.value
    return err


def ones_plan(b: int, nq: int, c: int, heads: int,
              sms: int = fa.H100_SMS) -> "tuple[int, int, int] | None":
    """(q rows of a CTA, ring stages, head groups) of the ones kernel: K1's
    plan at D 64 (`flash_attention.packed_plan`), its stages sized for
    ONES_STAGE."""
    plan = fa.packed_plan(nq, c, heads, b, sms, ONES_STAGE)
    return None if plan is None else (plan[0], plan[2], plan[3])


def _ones_launch(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, heads: int, exact: bool, ones_mode: int) -> torch.Tensor:
    b, nq, c = q.shape
    nk = k.shape[1]
    v_cols = 2 * c if ones_mode == ONES_FROM_V else c
    _check(what, q.device, {"k": (k, (b, nk, c)), "v": (v, (b, nk, v_cols))}, heads, c)
    _bf16(what, q, k, v)
    if nq < 1 or nk < 1:
        raise ValueError(f"{what}: Nq and Nk must be >= 1, got {nq}, {nk}")
    rows, stages, groups = ones_plan(b, nq, c, heads, fa._sms(q.device.index))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    err = _launch("mdt_attn_ones", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, nq, nk, c, heads, v_cols, ones_mode, float(scale), int(exact), rows,
                  stages, groups, _stream(q.device))
    _build.check(err, f"{what} launch")
    return out


def flash_attention_packed_ones(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, heads: int,
                                exact: bool = True) -> torch.Tensor:
    """q (B, Nq, C), k/v (B, Nk, C) -> (B, Nq, C) with the host-side ones
    fold (K10a). Counts its launches in `.launches`."""
    va = augment_v(v, heads)
    if q.device.type == "cpu":
        return attn_ones_plain(q, k, va, scale, heads, exact)
    out = _ones_launch("flash_attention_packed_ones", q, k, va, scale, heads, exact,
                       ONES_FROM_V)
    flash_attention_packed_ones.launches += 1
    return out


def ones_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   heads: int, exact: bool = True) -> torch.Tensor:
    """K11: K10a's function over K10a's kernel. Counts its launches in
    `.launches`."""
    va = augment_v(v, heads)
    if q.device.type == "cpu":
        return attn_ones_plain(q, k, va, scale, heads, exact)
    out = _ones_launch("ones_attention", q, k, va, scale, heads, exact, ONES_FROM_V)
    ones_attention.launches += 1
    return out


def flash_attention_packed_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, heads: int,
                                exact: bool = True) -> torch.Tensor:
    """K10a's function with the ones column built inside the kernel (K10b);
    head dim 64 only. Counts its launches in `.launches`."""
    c = q.shape[-1]
    if c % heads or c // heads != 64:
        raise ValueError(f"fold path requires head_dim 64, got C={c}, heads={heads}")
    if q.device.type == "cpu":
        return attn_ones_plain(q, k, augment_v(v, heads), scale, heads, exact)
    out = _ones_launch("flash_attention_packed_fold", q, k, v, scale, heads, exact,
                       ONES_IN_KERNEL)
    flash_attention_packed_fold.launches += 1
    return out


def _out_checks(what: str, q: torch.Tensor, k: torch.Tensor, wo: torch.Tensor,
                bo: torch.Tensor, heads: int) -> None:
    b, nq, c = q.shape
    nk, c_out = k.shape[1], wo.shape[1]
    _check(what, q.device, {"wo": (wo, (c, c_out)), "bo": (bo, (c_out,))}, heads, c)
    if c > KERNEL_MAX_C or c_out % 8 or nq < 1 or nk < 1:
        raise ValueError(f"{what}: the kernel takes C <= {KERNEL_MAX_C}, C_out % 8 == 0 "
                         f"and Nq, Nk >= 1; got C={c}, C_out={c_out}, Nq={nq}, Nk={nk}")


def _attend_out(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: int,
                wo: torch.Tensor, bo: torch.Tensor, scale: float, heads: int,
                exact: bool) -> torch.Tensor:
    """mdt_attn_out on (B, N, C) views whose rows are `ld` elements apart."""
    b, nq, c = q.shape
    wo = wo.to(torch.bfloat16).contiguous()
    bo = bo.float().contiguous()
    out = torch.empty(b, nq, wo.shape[1], dtype=torch.bfloat16, device=q.device)
    err = _launch("mdt_attn_out", q.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
                  bo.data_ptr(), out.data_ptr(), b, nq, k.shape[1], c, wo.shape[1], heads, ld,
                  float(scale), int(exact), _stream(q.device))
    _build.check(err, f"{what} launch")
    return out


def _proj_qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
              scale: float) -> torch.Tensor:
    """K10c's first launch: (B, N, 3C) = x @ [bf16(Wq * scale) | Wk | Wv],
    fp32 sums rounded to bf16 (Wq * scale in fp32, then rounded)."""
    b, n, c = x.shape
    wqs = (wq.float() * scale).to(torch.bfloat16).contiguous()
    wk, wv = (w.to(torch.bfloat16).contiguous() for w in (wk, wv))
    y = torch.empty(b, n, 3 * c, dtype=torch.bfloat16, device=x.device)
    err = _launch("mdt_qkv_proj", x.data_ptr(), wqs.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                  y.data_ptr(), b * n, c, _stream(x.device))
    _build.check(err, "flash_attention_packed_proj projection launch")
    return y


def _proj_attend(y: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, heads: int,
                 exact: bool) -> torch.Tensor:
    """K10c's second launch: K10d's kernel on the q, K', V' column blocks of
    `_proj_qkv`'s output, at scale 1."""
    c = y.shape[-1] // 3
    q, k, v = y[..., :c], y[..., c:2 * c], y[..., 2 * c:]
    return _attend_out("flash_attention_packed_proj", q, k, v, 3 * c, wo, bo, 1.0, heads,
                       exact)


def flash_attention_packed_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               wo: torch.Tensor, bo: torch.Tensor, scale: float,
                               heads: int, exact: bool = True) -> torch.Tensor:
    """attention(q, k, v) @ Wo + bo (K10d): q (B, Nq, C), k/v (B, Nk, C),
    wo (C, C_out), bo (C_out,) -> (B, Nq, C_out). Counts its launches in
    `.launches`."""
    if q.device.type == "cpu":
        return attn_out_plain(q, k, v, wo, bo, scale, heads, exact)
    what = "flash_attention_packed_out"
    b, nq, c = q.shape
    nk = k.shape[1]
    _check(what, q.device, {"k": (k, (b, nk, c)), "v": (v, (b, nk, c))}, heads, c)
    _bf16(what, q, k, v)
    _out_checks(what, q, k, wo, bo, heads)
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = _attend_out(what, q, k, v, c, wo, bo, scale, heads, exact)
    flash_attention_packed_out.launches += 1
    return out


def flash_attention_packed_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                                wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                                scale: float, heads: int, block_q: int = 256,
                                exact: bool = True) -> torch.Tensor:
    """to_out(attention(x Wq, x Wk, x Wv)) (K10c): x (B, N, C), w* (C, C),
    bo (C,) -> (B, N, C). N must be a multiple of min(block_q, N), as the
    TPU kernel's grid requires. Counts its launches in `.launches`, one for
    the two kernel launches of a call."""
    b, n, c = x.shape
    qb = min(block_q, n)
    if n % qb:
        raise ValueError(f"flash_attention_packed_proj needs N % block_q == 0, got "
                         f"N={n}, block_q={qb}")
    if x.device.type == "cpu":
        return attn_proj_plain(x, wq, wk, wv, wo, bo, scale, heads, exact)
    what = "flash_attention_packed_proj"
    _check(what, x.device, {f"w{s}": (w, (c, c)) for s, w in zip("qkv", (wq, wk, wv))},
           heads, c)
    _bf16(what, x)
    _out_checks(what, x, x, wo, bo, heads)
    out = _proj_attend(_proj_qkv(x.contiguous(), wq, wk, wv, scale), wo, bo, heads, exact)
    flash_attention_packed_proj.launches += 1
    return out


for _fn in (flash_attention_packed_ones, flash_attention_packed_fold,
            flash_attention_packed_proj, flash_attention_packed_out, ones_attention):
    _fn.launches = 0
