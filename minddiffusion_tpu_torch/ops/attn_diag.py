"""The ds1 attention ablations (K12): four hand-written Hopper kernels behind
four wrappers, each beside its plain version.

Port of the diagnostic TPU kernels of benchmarks/bench_attn_ds1.py, on
packed (B, N, C = heads * D) tensors, head h being the column slice
[h*D, (h+1)*D). Each cuts stages out of the packed attention kernel (K1):
  * `diag(q, k, v, heads, mode)` (`_diag_kernel`): mode "qk" (the row sum
    of s broadcast over the head's columns), "exp" (the row sum of exp(s)),
    "nosm" (bf16(s) @ v), "fp32pv" (exp(s) @ v with P in fp32) or "full"
    (bf16(exp(s)) @ v / the fp32 row sum of exp(s));
  * `diag_kt(q, k, v, heads, mode)` (`_diag_kt_kernel`): "qk" or "full"
    with K transposed to (B, C, N) inside the call, as the TPU function
    does;
  * `diag_slice(q, k, v, heads, mode)` (`_diag_slice_kernel`): "slice"
    s[:, :D] or "expslice" exp(s)[:, :D], the scores against the first D
    keys; v is not read;
  * `diag_bf16s(q, k, v, heads, exp)` (`_diag_bf16s_kernel`): p =
    exp(bf16(s)) in q's dtype, (p @ v) / the fp32 sum of p; on the card
    the exp is the fp32 one ("fp32") or the packed bf16 one ("bf16x2",
    `ex2.approx.ftz.bf16x2`), whose value at each of the 65536 bf16 inputs
    `exp_bf16x2_table` reads from the kernel's own code.
s = q_h k_h^T in fp32 with no scale and no max subtracted, as on the TPU:
exp overflows fp32 above logit ~88.72, and those rows come out inf or NaN
in both the kernels and the plain versions. The output is in q's dtype.

Each wrapper takes its plain version only for CPU tensors; for CUDA
tensors it launches its kernel (bf16, D = 64, N % 64 == 0) or raises, and
counts the launch in `.launches`. CUDA source csrc/attn_diag.cu: every mode
is K1's attention core (csrc/attn_core.cuh) with stages cut out, launched
as `diag_plan` says. No path of either package calls them: the shootout
(`bench/attn_ds1.py`) and chip_smoke.py phase 28 drive them. The plain
versions run one batch element and one head at a time, so an (N, N) fp32
score matrix is the largest temporary (64 MB at N 4096).
"""
from __future__ import annotations

import ctypes

import torch

from minddiffusion_tpu_torch.ops import _build, flash_attention as fa

MODES = ("qk", "exp", "nosm", "fp32pv", "full")
KT_MODES = ("qk", "full")
SLICE_MODES = ("slice", "expslice")
BF16S_EXPS = ("fp32", "bf16x2")
KERNEL_HEAD_DIM = 64
KEY_TILE = 64
_MODE_IDS = {"qk": 0, "exp": 1, "nosm": 2, "fp32pv": 3, "full": 4, "slice": 5,
             "expslice": 6}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {   # q, k, v, o, work, 8 ints (the shape, the mode, the plan), the stream, int* ctas
    **{fn: [_P] * 5 + [_I] * 8 + [_P, _P]
       for fn in ("mdt_diag", "mdt_diag_kt", "mdt_diag_slice", "mdt_diag_bf16s")},
    "mdt_exp_bf16x2_table": [_P, _P],
}
_EXP_TABLES: dict = {}
last_ctas: dict = {}   # CTAs of each entry's last launch, as its C entry reports them
# Bytes of a ring stage of the core: a K tile of 64 keys; with a V tile
# where PV runs; fp32pv's V^T tile is fp32, twice a bf16 one
_K_TILE = KEY_TILE * KERNEL_HEAD_DIM * 2
_NO_V = ("qk", "exp", "slice", "expslice")


def diag_plan(mode: str, b: int, n: int, c: int, heads: int,
              sms: int = fa.H100_SMS) -> "tuple[int, int, int] | None":
    """(q rows of a CTA, ring stages, head groups) of a K12 mode's launch
    (`mode`: one of MODES, SLICE_MODES or "bf16s"; kt's modes as their
    plain names): K1's plan at D 64 (`flash_attention.packed_plan`), its
    stages sized for the mode's stage (a K tile only where no V is read,
    fp32pv's fp32 V^T tile); fp32pv takes at most 128 rows (its 192-row
    kernel spilled)."""
    stage = _K_TILE * (1 if mode in _NO_V else 3 if mode == "fp32pv" else 2)
    plan = fa.packed_plan(n, c, heads, b, sms, stage, 128 if mode == "fp32pv" else 192)
    return None if plan is None else (plan[0], plan[2], plan[3])


def _check_mode(what: str, mode: str, allowed: tuple) -> None:
    if mode not in allowed:
        raise ValueError(f"{what}: mode must be one of {allowed}, got {mode!r}")


def _per_head(q: torch.Tensor, heads: int, fn) -> torch.Tensor:
    """out[i, :, columns sl of head h] = fn(i, sl), in q's dtype."""
    b, _, c = q.shape
    d = c // heads
    out = torch.empty_like(q)
    for i in range(b):
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            out[i, :, sl] = fn(i, sl).to(q.dtype)
    return out


def _scores(q: torch.Tensor, kt: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 q_h @ kt (kt: (D, Nk)), times `scale` unless it is 1."""
    s = torch.matmul(q.float(), kt.float())
    return s if scale == 1.0 else s * scale


def _row_sum(x: torch.Tensor, d: int) -> torch.Tensor:
    return x.sum(dim=-1, keepdim=True).expand(-1, d)


def diag_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               mode: str, score_scale: float = 1.0) -> torch.Tensor:
    """`diag`'s math: fp32 scores, then the mode's stages in fp32, P rounded
    to v's dtype before PV in "nosm" and "full". `score_scale` multiplies
    the fp32 scores (every plain version takes it: chip_smoke.py moves s by
    a few fp32 ulps with it to find the outputs whose overflow turns on the
    last bits of s)."""
    _check_mode("diag_plain", mode, MODES)
    d = q.shape[-1] // heads

    def head(i, sl):
        s = _scores(q[i, :, sl], k[i, :, sl].T, score_scale)
        if mode == "qk":
            return _row_sum(s, d)
        p = s if mode == "nosm" else torch.exp(s)
        if mode == "exp":
            return _row_sum(p, d)
        vh = v[i, :, sl].float()
        if mode == "fp32pv":
            return torch.matmul(p, vh)
        acc = torch.matmul(p.to(v.dtype).float(), vh)
        return acc / p.sum(dim=-1, keepdim=True) if mode == "full" else acc

    return _per_head(q, heads, head)


def diag_kt_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  mode: str, score_scale: float = 1.0) -> torch.Tensor:
    """`diag_kt`'s math: the scores against K^T (B, C, N), then "qk" or
    "full" as in `diag_plain`."""
    _check_mode("diag_kt_plain", mode, KT_MODES)
    d = q.shape[-1] // heads
    kt = k.transpose(1, 2)

    def head(i, sl):
        s = _scores(q[i, :, sl], kt[i, sl], score_scale)
        if mode == "qk":
            return _row_sum(s, d)
        p = torch.exp(s)
        acc = torch.matmul(p.to(v.dtype).float(), v[i, :, sl].float())
        return acc / p.sum(dim=-1, keepdim=True)

    return _per_head(q, heads, head)


def diag_slice_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     mode: str, score_scale: float = 1.0) -> torch.Tensor:
    """`diag_slice`'s math: the fp32 scores (or their exp) against the first
    D keys."""
    _check_mode("diag_slice_plain", mode, SLICE_MODES)
    d = q.shape[-1] // heads

    def head(i, sl):
        s = _scores(q[i, :, sl], k[i, :d, sl].T, score_scale)
        return torch.exp(s) if mode == "expslice" else s

    return _per_head(q, heads, head)


def exp_rounded(s: torch.Tensor, dtype: torch.dtype,
                exp_table: "torch.Tensor | None" = None) -> torch.Tensor:
    """The fp32 value of exp(s rounded to `dtype`) in `dtype`: by torch.exp,
    or, for bf16, read from `exp_table` (65536 values indexed by the bits of
    bf16(s), as `exp_bf16x2_table` gives them)."""
    if exp_table is None:
        return torch.exp(s.to(dtype)).float()
    if dtype != torch.bfloat16:
        raise TypeError(f"exp_rounded: an exp table is indexed by bf16 bits, not {dtype}")
    return exp_table.float()[s.to(dtype).view(torch.int16).long() & 0xFFFF]


# A kernel and its plain version sum s's 64 products in other orders, so s
# differs in its last bits: a score within BOUNDARY_EPS (relative; ~100
# fp32 ulps, above the ~2^-18 worst case of a 64-term fp32 sum) of a bf16
# rounding midpoint may round to the other side in one of them, and bf16s's
# exp(bf16(s)) then jumps by a bf16 step (28% at s ~ 40).
BOUNDARY_EPS = 2.0 ** -16


def bf16s_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, exp_table: "torch.Tensor | None" = None) -> torch.Tensor:
    """An upper bound, per output of bf16s, on how far it moves when the
    scores within BOUNDARY_EPS (relative) of a bf16 rounding midpoint
    round to the other side, in any combination: with dp_j the change of
    p_j = exp(bf16(s_j)) at such a key (0 elsewhere), the row's o = P V / l
    becomes o + sum_j dp_j (v_j - o) / (l + sum_j dp_j), so it moves by at
    most sum_j |dp_j| |v_j - o| / (l - sum_j |dp_j|); and by at most
    max_j |v_j| + |o|, since o stays a convex combination of the v_j. The
    exp is the one of `exp_table` (`exp_rounded`)."""
    b, n, c = q.shape
    d = c // heads
    out = torch.empty(b, n, c, device=q.device)
    for i in range(b):
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            s = torch.matmul(q[i, :, sl].float(), k[i, :, sl].float().T)
            sb = s.to(torch.bfloat16)
            bits = sb.view(torch.int16).to(torch.int32)
            # the other bf16 neighbour of s: one step up or down the bit pattern
            step = torch.where((s > sb.float()) ^ (bits < 0), 1, -1)
            other = (bits + step).to(torch.int16).view(torch.bfloat16)
            p = exp_rounded(sb, torch.bfloat16, exp_table)
            near = (s - (sb.float() + other.float()) / 2).abs() <= BOUNDARY_EPS * s.abs()
            dp = torch.where(near, (exp_rounded(other, torch.bfloat16, exp_table) - p).abs(), 0.0)
            vh = v[i, :, sl].float()
            l = p.sum(-1, keepdim=True)
            o = torch.matmul(p, vh) / l
            rows, keys = dp.nonzero(as_tuple=True)       # the few keys near a midpoint
            moved = dp[rows, keys, None] * (vh[keys] - o[rows]).abs()
            num = torch.zeros_like(o).index_add_(0, rows, moved)
            cap = vh.abs().amax(0) + o.abs()
            out[i, :, sl] = torch.minimum(
                num / (l - dp.sum(-1, keepdim=True)).clamp_min(0.0), cap)
    return out


def diag_bf16s_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, score_scale: float = 1.0,
                     exp_table: "torch.Tensor | None" = None) -> torch.Tensor:
    """`diag_bf16s`'s math: p = exp(s rounded to q's dtype) in q's dtype,
    l the fp32 sum of p, (p @ v) / l with fp32 accumulation. `exp_table`:
    the exp's values in bf16 (`exp_rounded`), torch.exp's by default."""
    def head(i, sl):
        s = _scores(q[i, :, sl], k[i, :, sl].T, score_scale)
        p = exp_rounded(s, q.dtype, exp_table)
        return torch.matmul(p, v[i, :, sl].float()) / p.sum(dim=-1, keepdim=True)

    return _per_head(q, heads, head)


def _launch(what: str, fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int, mode: str, mode_id: int, k_shape: tuple) -> torch.Tensor:
    b, n, c = q.shape
    for name, t, shape in (("k", k, k_shape), ("v", v, q.shape)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}, got {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bfloat16, got {t.dtype}")
    if c % heads or c // heads != KERNEL_HEAD_DIM or n < KEY_TILE or n % KEY_TILE:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HEAD_DIM} and N a "
                         f"multiple of {KEY_TILE}; got C={c}, heads={heads}, N={n}")
    rows, stages, groups = diag_plan(mode, b, n, c, heads, fa._sms(q.device.index))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    # fp32pv's V^T in fp32, written by the call's first launch
    work = torch.empty(b, c, n, device=q.device) if mode == "fp32pv" else None
    lib = _build.load("attn_diag", _SIGNATURES)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           None if work is None else work.data_ptr(), b, n, c, heads, mode_id,
                           rows, stages, groups, stream, ctypes.byref(ctas))
    _build.check(err, f"{what} launch")
    last_ctas[fn] = ctas.value
    return out


def diag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
         mode: str) -> torch.Tensor:
    """q, k, v (B, N, C) -> (B, N, C) in q's dtype: `_diag_kernel`'s mode.
    Counts its launches in `.launches`."""
    _check_mode("diag", mode, MODES)
    if q.device.type == "cpu":
        return diag_plain(q, k, v, heads, mode)
    out = _launch("diag", "mdt_diag", q, k, v, heads, mode, _MODE_IDS[mode], q.shape)
    diag.launches += 1
    return out


def diag_kt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            mode: str) -> torch.Tensor:
    """`diag` in mode "qk" or "full" with K transposed to (B, C, N) here,
    inside the call. Counts its launches in `.launches`."""
    _check_mode("diag_kt", mode, KT_MODES)
    if q.device.type == "cpu":
        return diag_kt_plain(q, k, v, heads, mode)
    kt = k.transpose(1, 2).contiguous()
    out = _launch("diag_kt", "mdt_diag_kt", q, kt, v, heads, mode, _MODE_IDS[mode],
                  (q.shape[0], q.shape[2], q.shape[1]))
    diag_kt.launches += 1
    return out


def diag_slice(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               mode: str) -> torch.Tensor:
    """s[:, :D] ("slice") or exp(s)[:, :D] ("expslice") per head. The kernel
    sweeps every key tile, as the TPU kernel computed the whole S row.
    Counts its launches in `.launches`."""
    _check_mode("diag_slice", mode, SLICE_MODES)
    if q.device.type == "cpu":
        return diag_slice_plain(q, k, v, heads, mode)
    out = _launch("diag_slice", "mdt_diag_slice", q, k, v, heads, mode, _MODE_IDS[mode],
                  q.shape)
    diag_slice.launches += 1
    return out


def diag_bf16s(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               exp: str = "fp32") -> torch.Tensor:
    """exp in bf16: (exp(bf16(s)) @ v) / its fp32 row sum, the kernel's exp
    the fp32 one or the packed bf16 one ("bf16x2"). Counts its launches in
    `.launches`."""
    if exp not in BF16S_EXPS:
        raise ValueError(f"diag_bf16s: exp must be one of {BF16S_EXPS}, got {exp!r}")
    if q.device.type == "cpu":
        return diag_bf16s_plain(q, k, v, heads)
    out = _launch("diag_bf16s", "mdt_diag_bf16s", q, k, v, heads, "bf16s",
                  BF16S_EXPS.index(exp), q.shape)
    diag_bf16s.launches += 1
    return out


def exp_bf16x2_table(device: torch.device) -> torch.Tensor:
    """(65536,) bf16 on a CUDA device: the packed bf16 exp of
    `diag_bf16s(..., exp="bf16x2")` at the bf16 whose bits are the index,
    computed once per device by the kernel's own exp code."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"exp_bf16x2_table: the packed exp runs on a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _EXP_TABLES:
        out = torch.empty(1 << 16, dtype=torch.bfloat16, device=device)
        lib = _build.load("attn_diag", _SIGNATURES)
        with torch.cuda.device(device):
            err = lib.mdt_exp_bf16x2_table(out.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
        _build.check(err, "exp_bf16x2_table launch")
        _EXP_TABLES[device] = out
    return _EXP_TABLES[device]


for _fn in (diag, diag_kt, diag_slice, diag_bf16s):
    _fn.launches = 0


# each variant's mode as `diag_plan` takes it
PLAN_MODES = {**{f"diag_{m}": m for m in MODES}, "diag_kt_qk": "qk", "diag_kt_full": "full",
              "diag_qk_slice": "slice", "diag_qkexp_slice": "expslice",
              "diag_bf16s": "bf16s", "diag_bf16s_ex2": "bf16s"}


def _bf16s_ex2_plain(q, k, v, heads, **kw):
    table = exp_bf16x2_table(q.device) if q.is_cuda else None
    return diag_bf16s_plain(q, k, v, heads, exp_table=table, **kw)


# What a hold's tolerance is relative to. Most modes' outputs are of one
# magnitude and are held against max |plain| over the tensor, as every
# other kernel is. The raw exp outputs are not: a row's values follow exp
# of its largest logit, e^30 to e^70 apart from row to row on the script's
# input, so max |plain| would check only the rows with the largest logits.
# "exp" (its row sum) and "fp32pv" (exp(s) @ v, signed) are held against
# each row's own max |plain| (a row: one token's columns of one head), and
# "qkexp_slice" (exp(s) itself) output by output.
ROW_SCALED = ("diag_exp", "diag_fp32pv")
ELEMENT_SCALED = ("diag_qkexp_slice",)


def hold_scale(name: str, ref: torch.Tensor, heads: int) -> torch.Tensor:
    """Per output of variant `name`, what its error is relative to: max
    |ref| over the finite outputs, over the row's (ROW_SCALED), or |ref|
    itself (ELEMENT_SCALED); 0 where ref is not finite."""
    mag = torch.where(torch.isfinite(ref), ref.float().abs(), 0.0)
    if name in ELEMENT_SCALED:
        return mag
    b, n, c = ref.shape
    if name in ROW_SCALED:
        rows = mag.view(b, n, heads, c // heads).amax(-1, keepdim=True)
        return rows.expand(b, n, heads, c // heads).reshape(b, n, c)
    return mag.max().expand_as(mag)


def variants() -> dict:
    """The ten modes under benchmarks/bench_attn_ds1.py's variant names,
    and "diag_bf16s_ex2" (bf16s with the packed bf16 exp): name ->
    (wrapper, plain version), each called as f(q, k, v, heads) (the plain
    one also with score_scale=). On the card the plain version of
    "diag_bf16s_ex2" takes its exp values from `exp_bf16x2_table`."""
    def bind(fn, mode):
        return (lambda q, k, v, heads, **kw: fn(q, k, v, heads, mode, **kw)) if mode else fn

    table = {f"diag_{m}": (diag, diag_plain, m) for m in MODES}
    table.update({f"diag_kt_{m}": (diag_kt, diag_kt_plain, m) for m in KT_MODES})
    table.update({"diag_qk_slice": (diag_slice, diag_slice_plain, "slice"),
                  "diag_qkexp_slice": (diag_slice, diag_slice_plain, "expslice"),
                  "diag_bf16s": (diag_bf16s, diag_bf16s_plain, None)})
    out = {name: (bind(fn, m), bind(plain, m)) for name, (fn, plain, m) in table.items()}
    out["diag_bf16s_ex2"] = (lambda q, k, v, heads: diag_bf16s(q, k, v, heads, "bf16x2"),
                             _bf16s_ex2_plain)
    return out
