"""Where the time of the wgmma attention kernels goes: K10d's (`mdt_attn_out`
in minddiffusion_tpu_torch/ops/csrc/attn_variants.cu) and K1's
(`mdt_packed_attention` in packed_attention.cu), which share the attention
core of csrc/attn_core.cuh. Builds copies of the sources with one piece
taken out each and times every copy on the card by `torch.profiler`
(device time only, no host overhead): K10d at the SD2 UNet's ds1 and ds2
shapes and K11's ds4 one, K1 at ds1 and ds2 (D 64, raw exp, as the main
path runs them) and at Wukong's D 40 / D 80 and GLIDE's sites at each row
tier. Then times K10c's first launch, the projection GEMM
(`mdt_qkv_proj`), alone on the device at K10c's ds1 and ds2 shapes.

    python3 scripts/attn_variants_ablate.py

Variants (the outputs of all but `full` are wrong by design):
  full         the kernels as they are
  no_exp       the numerators' ex2 replaced by a multiply (no MUFU)
  no_mma       S and PV not issued (no tensor-core work in the loop)
  skeleton     both: loads, barriers and the rest of the softmax
  no_epilogue  K10d: the Wo epilogue skipped (no Wo loads, products or stores)
  tiles_128    K10d: the 128-row tier at every C <= 640 (no 192-row tier)
  tiles_<r>    K1: the full kernel launched with r q rows a CTA in place of
               its plan's (every tier its head dim has)
Needs the CUDA toolkit and one card; builds into a temporary directory.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from minddiffusion_tpu_torch.ops import (_build, attn_variants as av,  # noqa: E402
                                         flash_attention as fa)

EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
S = ("    wgmma_rs<H::KT, 0>(s, qf[kk], smem_desc(kslot + (kk / 4) * H::BOX + (kk % 4) * 32, 16, "
     "1024),\n                       kk);")
PV = ("    wgmma_rs<H::D, 1>(o, p[kk], smem_desc(vslot + kk * 2048, H::VBOX > 1 ? H::BOX : 1024, "
      "1024),\n                      accumulate | kk);")
EPI = "for (int n0 = 0; n0 < c_out; n0 += EPI_N)"
TIER = "return c <= WIDEST_MAX_C && nq >= WIDEST_MIN_NQ ? 192 : c <= WIDE_MAX_C ? 128 : 64;"
CORE = "attn_core.cuh"
VARIANTS = {   # name: [(file, text, its replacement)], the file attn_core.cuh or the source's
    "full": [],
    "no_exp": [(CORE, EX2, "  y = x * 0.5f;")],
    "no_mma": [(CORE, S, "    ;"), (CORE, PV, "    ;")],
    "skeleton": [(CORE, EX2, "  y = x * 0.5f;"), (CORE, S, "    ;"), (CORE, PV, "    ;")],
    "no_epilogue": [("attn_variants.cu", EPI, "for (int n0 = 0; n0 < 0; n0 += EPI_N)")],
    "tiles_128": [("attn_variants.cu", TIER, "return c <= WIDE_MAX_C ? 128 : 64;")],
}
K1_VARIANTS = ("full", "no_exp", "no_mma", "skeleton")
K1_TIERS = {40: (128, 64), 64: (192, 128, 64), 80: (128, 64), 160: (64,)}
CASES = [  # (label, B, N, C, exact): self-attention, C_out = C
    ("ds1_16x4096x320", 16, 4096, 320, False),
    ("ds2_16x1024x640", 16, 1024, 640, False),
    ("ds2_16x1024x640", 16, 1024, 640, True),
    ("ds4_16x256x1280", 16, 256, 1280, True),
]
K1_CASES = [  # (label, B, Nq, Nk, C, heads, exact, stage cuts): the main path's two
    # sites (raw exp) with every cut, then Wukong's and GLIDE's with the row tiers only
    ("ds1_16x4096x320", 16, 4096, 4096, 320, 5, False, True),
    ("ds2_16x1024x640", 16, 1024, 1024, 640, 10, False, True),
    ("wukong_ds1_8x4096x320_d40", 8, 4096, 4096, 320, 8, True, False),
    ("wukong_ds2_8x1024x640_d80", 8, 1024, 1024, 640, 8, True, False),
    ("glide_ds2_16x1024x1152x384", 16, 1024, 1152, 384, 6, True, False),
]
GEMM_CASES = [  # (label, B, N, C): K10c's x @ [Wq | Wk | Wv], M = B N, N = 3C, K = C
    ("ds1_16x4096x320", 16, 4096, 320),
    ("ds2_16x1024x640", 16, 1024, 640),
]


def build(tmp: Path, source: str, names, signatures: dict) -> dict:
    """{variant: its library}: each variant's copies of csrc/<source>.cu and
    attn_core.cuh in a directory of its own (the .cu's quoted include finds
    the copy first), built in parallel."""
    procs = {}
    for name in names:
        texts = {f: (_build.CSRC / f).read_text() for f in (CORE, f"{source}.cu")}
        for f, old, new in VARIANTS[name]:
            if f not in texts:
                continue
            if old not in texts[f]:
                raise RuntimeError(f"{name}: {f} no longer holds {old.strip()!r}")
            texts[f] = texts[f].replace(old, new)
        d = tmp / f"{source}_{name}"
        d.mkdir()
        for f, text in texts.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(d / "lib.so"), str(d / f"{source}.cu")], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {source} {name}:\n{proc.stderr.read()}")
        lib = ctypes.CDLL(str(tmp / f"{source}_{name}" / "lib.so"))
        for entry, argtypes in signatures.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, kernel: str = "attn_out_kernel", runs: int = 10) -> float:
    """Mean device time of the kernel `kernel` launched by `fn`, in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if kernel in e.key)
    return total / runs / 1000.0


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_variants_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        k1_libs = build(Path(tmp), "packed_attention", K1_VARIANTS, fa._SIGNATURES)
        libs = build(Path(tmp), "attn_variants", VARIANTS,
                     {k: av._SIGNATURES[k] for k in ("mdt_attn_out", "mdt_qkv_proj")})
        for label, b, nq, nk, c, heads, exact, cuts in K1_CASES:
            q = torch.randn(b, nq, c, generator=gen, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn(b, nk, c, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            out = torch.empty_like(q)
            rows, key_tile, _, groups = fa.packed_plan(nq, c, heads, b)
            d = c // heads
            runs = [(name, k1_libs[name], rows) for name in (K1_VARIANTS if cuts else ("full",))]
            runs += [(f"tiles_{r}", k1_libs["full"], r) for r in K1_TIERS[d] if r != rows]
            row = []
            for name, lib, r in runs:
                st = fa.ring_stages(c // groups, d, r, key_tile)
                if st < 2:   # an r-row q tile leaves no room for the ring here
                    continue

                def call(lib=lib, r=r, st=st):
                    err = lib.mdt_packed_attention(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk, c,
                        heads, d ** -0.5, int(exact), r, key_tile, st, groups,
                        torch.cuda.current_stream().cuda_stream, None)
                    _build.check(err, f"{name} rows {r} stages {st}")
                row.append(f"{name} {device_ms(call, 'packed_attn_kernel'):.4f}")
            print(f"K1 {label} exact={exact} rows={rows} groups={groups} device ms: "
                  + ", ".join(row), flush=True)
        for label, b, n, c, exact in CASES:
            q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            wo = (torch.randn(c, c, generator=gen, device="cuda") * c ** -0.5).to(torch.bfloat16)
            bo = 0.1 * torch.randn(c, generator=gen, device="cuda")
            out = torch.empty_like(q)
            row = []
            for name, lib in libs.items():
                def call(lib=lib):
                    err = lib.mdt_attn_out(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, n, n,
                                           c, c, c // 64, c, 0.125, int(exact),
                                           torch.cuda.current_stream().cuda_stream, None)
                    _build.check(err, name)
                row.append(f"{name} {device_ms(call):.4f}")
            print(f"{label} exact={exact} device ms: " + ", ".join(row), flush=True)
        for label, b, n, c in GEMM_CASES:
            x = torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
            wq, wk, wv = ((torch.randn(c, c, generator=gen, device="cuda") * c ** -0.5)
                          .to(torch.bfloat16) for _ in range(3))
            y = torch.empty(b, n, 3 * c, dtype=torch.bfloat16, device="cuda")

            def gemm():
                err = libs["full"].mdt_qkv_proj(x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                                                wv.data_ptr(), y.data_ptr(), b * n, c,
                                                torch.cuda.current_stream().cuda_stream, None)
                _build.check(err, "qkv_proj")
            print(f"{label} qkv_proj_kernel device ms: "
                  f"{device_ms(gemm, 'qkv_proj_kernel'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
