"""Attention shootout at SD2's hottest site: the 512^2 UNet's ds1
self-attention (B 16 CFG-folded, N 4096, C 320, 5 heads x 64), the port's
counterpart of benchmarks/bench_attn_ds1.py.

    python -m minddiffusion_tpu_torch.bench.attn_ds1 [variant ...]
    python -m minddiffusion_tpu_torch.bench.attn_ds1 --device cpu --shape 2,256,128,2

Each variant runs the script's dependent step, h <- attn(h, h, h) * 1e-3 +
h * 0.999 in h's dtype, STEPS = 20 times on x = RandomState(0).randn(B, N,
C) in bf16 (the script's input); its time per op is the least of 3 such
runs over 20, by CUDA events, after one warm run. Printed per variant:
ms/op, TFLOP/s at the script's 4 B H N^2 D, and the variant's bound on the
H100 (the largest of its tensor-core time at 989 TFLOP/s bf16 or 495 TF32,
its exp time at 16 fp32 exps a clock per SM at the card's max SM clock, and
its HBM time at 3.35 TB/s; `bound`). The first line names the card and its
power limit. The default device is the card; `--device cpu` runs the same
variants, whose wrappers take their plain versions on CPU tensors, at the
`--shape B,N,C,heads` given, timed by the host clock (a CPU number, not a
device one).

Variants, with the JAX script's names they stand for:
  packed_fast, packed_exact  K1 (`flash_attention_packed`), raw-exp or
                             exact softmax. The JAX block_q sweep
                             (packed_bq128..2048_*) and its `grouped` forms
                             are TPU VMEM tilings; K1 has one Hopper plan
                             (64-row q tiles), so one name per softmax mode.
  ones_fast                  K10a (ones_bq256/512_fast), from
                             ops/attn_variants.py: the JAX script calls a
                             function its package no longer has.
  fold_fast, fold_exact      K10b (fold_bq256/512_fast, fold_bq256_exact).
  bhnd_fast                  K4 (`flash_attention`) on (B, N, H, D) views,
                             exp(s - 20) (bhnd_q512_k4096/1024_fast: the k
                             block is a TPU tiling).
  diag_qk ... diag_bf16s     K12, the ten ablation modes (ops/attn_diag.py),
                             under the script's names.
  diag_bf16s_ex2             K12's bf16s with the packed bf16 exp
                             (ex2.approx.ftz.bf16x2) in place of the fp32 one.
  sdpa_flash                 `splash`'s place: F.scaled_dot_product_attention
                             on the flash backend, the library yardstick
                             (not a port; the port never calls it).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.ops import attn_diag, attn_variants, flash_attention as fa

B, N, C, H = 16, 4096, 320, 5
STEPS = 20
RUNS = 3
# H100 SXM dense peaks (NVIDIA data sheet) at the 700 W limit, the ones
# every bound of the port's measurements uses; the exp rate is 16 MUFU ops
# a clock per SM on 132 SMs at the max SM clock
PEAK_BF16, PEAK_TF32, PEAK_BYTES = 989e12, 495e12, 3.35e12
MUFU_PER_CLOCK = 16 * 132
DEFAULT_MAX_SM_MHZ = 1980.0


def flops(b: int, n: int, c: int) -> float:
    """The script's FLOPS, 4 B H N^2 D = 4 B N^2 C."""
    return 4.0 * b * n * n * c


def _diag_work(name: str, b: int, n: int, c: int,
               heads: int) -> Tuple[float, float, float, float]:
    """(bf16 tensor-core flops, TF32 flops, fp32 exps, HBM bytes) that a K12
    mode's function needs: each input it reads once, the output written
    once. The slice modes' output depends on the first D keys only."""
    d = c // heads
    mode = name[len("diag_"):]
    slice_mode = mode in ("qk_slice", "qkexp_slice")
    nk = d if slice_mode else n
    qk = 2.0 * b * n * nk * c
    pv = 2.0 * b * n * n * c
    uses_v = mode in ("nosm", "fp32pv", "full", "kt_full", "bf16s", "bf16s_ex2")
    bf16 = qk + (pv if uses_v and mode != "fp32pv" else 0.0)
    tf32 = pv if mode == "fp32pv" else 0.0
    exps = b * heads * n * nk if mode not in ("qk", "kt_qk", "nosm", "qk_slice") else 0.0
    if mode == "bf16s_ex2":   # one packed op per two exps
        exps /= 2
    nbytes = 2.0 * b * c * (2 * n + nk + (n if uses_v else 0))
    return bf16, tf32, exps, nbytes


def attention_work(b: int, heads: int, nq: int, nk: int,
                   d: int) -> Tuple[float, float, float, float]:
    """(bf16 flops, TF32 flops, exps, HBM bytes) of attention: QK^T and PV
    on the tensor cores, one exp per score, q, k, v read and out written
    once in bf16."""
    return 4.0 * b * heads * nq * nk * d, 0.0, float(b * heads * nq * nk), \
        2.0 * b * heads * d * (2 * nq + 2 * nk)


def work_bound(bf16: float, tf32: float, exps: float, nbytes: float,
               exp_per_s: float) -> Tuple[float, str, str]:
    """(ms, "operations" or "bytes", the term that bounds: "mma", "exp" or
    "bytes"): the largest of the tensor-core, exp and HBM times of the work
    on the H100."""
    terms = {"mma": (bf16 / PEAK_BF16 + tf32 / PEAK_TF32) * 1e3,
             "exp": exps / exp_per_s * 1e3 if exps else 0.0,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def bound(name: str, b: int, n: int, c: int, heads: int,
          exp_per_s: float) -> Tuple[float, str, str]:
    """`work_bound` of a variant at (b, n, c, heads). Every non-K12
    variant computes attention (`attention_work`)."""
    if name.startswith("diag_"):
        return work_bound(*_diag_work(name, b, n, c, heads), exp_per_s)
    return work_bound(*attention_work(b, heads, n, n, c // heads), exp_per_s)


def variants(heads: int, c: int) -> Dict[str, Callable]:
    """name -> f(q, k, v) on (B, N, C) tensors."""
    d = c // heads
    scale = d ** -0.5

    def bhnd(q, k, v):
        b, n, _ = q.shape
        o = fa.flash_attention(*(t.reshape(b, n, heads, d) for t in (q, k, v)), scale,
                               False)
        return o.reshape(b, n, c)

    def sdpa(q, k, v):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        b, n, _ = q.shape
        views = [t.view(b, n, heads, d).transpose(1, 2) for t in (q, k, v)]
        backend = SDPBackend.FLASH_ATTENTION if q.is_cuda else SDPBackend.MATH
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(*views, scale=scale)
        return o.transpose(1, 2).reshape(b, n, c)

    table = {
        "packed_fast": lambda q, k, v: fa.flash_attention_packed(q, k, v, heads, scale, False),
        "packed_exact": lambda q, k, v: fa.flash_attention_packed(q, k, v, heads, scale, True),
        "ones_fast": lambda q, k, v: attn_variants.flash_attention_packed_ones(
            q, k, v, scale, heads, False),
        "fold_fast": lambda q, k, v: attn_variants.flash_attention_packed_fold(
            q, k, v, scale, heads, False),
        "fold_exact": lambda q, k, v: attn_variants.flash_attention_packed_fold(
            q, k, v, scale, heads, True),
        "bhnd_fast": bhnd,
    }
    for name, (fn, _) in attn_diag.variants().items():
        table[name] = lambda q, k, v, fn=fn: fn(q, k, v, heads)
    table["sdpa_flash"] = sdpa
    return table


VARIANTS = tuple(variants(H, C))


def script_input(b: int, n: int, c: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX script's x: RandomState(0).randn(B, N, C) in bf16."""
    x = torch.from_numpy(np.random.RandomState(0).randn(b, n, c).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def card_details() -> Tuple[str, float]:
    """(`nvidia-smi --query-gpu=name,power.limit` line, max SM clock in MHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    name, limit, clock = (s.strip() for s in smi.split(","))
    return f"{name}, {limit}", float(clock.split()[0])


def time_variant(fn: Callable, x: torch.Tensor, steps: int, runs: int) -> float:
    """Least ms per op over `runs` runs of `steps` dependent steps."""
    def run():
        h = x
        for _ in range(steps):
            h = (fn(h, h, h) * 1e-3 + h * 0.999).to(h.dtype)
        return h

    run()
    ts = []
    for _ in range(runs):
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts) / steps


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variants", nargs="*", help=f"default: all of {', '.join(VARIANTS)}")
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", default=f"{B},{N},{C},{H}", help="B,N,C,heads")
    p.add_argument("--steps", type=int, default=STEPS)
    return p


def main(argv=None) -> list:
    args = build_argparser().parse_args(argv)
    b, n, c, heads = (int(s) for s in args.shape.split(","))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
        card, max_mhz = card_details()
        print(f"device: {card}", flush=True)
    else:
        max_mhz = DEFAULT_MAX_SM_MHZ
        print(f"device: cpu (host clock; the bounds are the H100's at "
              f"{DEFAULT_MAX_SM_MHZ:.0f} MHz)", flush=True)
    table = variants(heads, c)
    names = args.variants or list(table)
    unknown = [v for v in names if v not in table]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(table)}")
    exp_per_s = MUFU_PER_CLOCK * max_mhz * 1e6
    print(f"shape B{b} N{n} C{c} h{heads}  flops/op {flops(b, n, c) / 1e12:.3f} T  "
          f"steps {args.steps}", flush=True)
    x = script_input(b, n, c, device)
    results = []
    for name in names:
        ms = time_variant(table[name], x, args.steps, RUNS)
        bound_ms, bound_by, term = bound(name, b, n, c, heads, exp_per_s)
        clock = "ms" if device.type == "cuda" else "cpu_ms"
        print(f"{name:18s}: {ms:8.4f} {clock}  {flops(b, n, c) / ms / 1e9:7.2f} T  "
              f"bound {bound_ms:.4f} ms ({term})", flush=True)
        results.append(dict(name=name, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                            bound_term=term, device=device.type))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
