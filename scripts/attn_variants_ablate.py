"""Where the time of the wgmma attention kernels goes: K10d's (`mdt_attn_out`
in minddiffusion_tpu_torch/ops/csrc/attn_variants.cu), K1's
(`mdt_packed_attention` in packed_attention.cu), K12's modes (`mdt_diag*`
in attn_diag.cu) and the ones kernel of K10a / K10b / K11 (`mdt_attn_ones`),
which share the attention core of csrc/attn_core.cuh. Builds copies of the
sources with one piece taken out each and times every copy on the card by
`torch.profiler` (device time only, no host overhead): K10d at the SD2
UNet's ds1 and ds2 shapes and K11's ds4 one, K1 at ds1 and ds2 (D 64, raw
exp, as the main path runs them) and at Wukong's D 40 / D 80 and GLIDE's
sites at each row tier, K12's full, kt_full, bf16s_ex2 and fp32pv at ds1,
the ones kernel at ds1, ds2 and ds4. Then times K10c's first launch, the
projection GEMM (`mdt_qkv_proj`), alone on the device at K10c's ds1 and ds2
shapes.

    python3 scripts/attn_variants_ablate.py
    python3 scripts/attn_variants_ablate.py --events [--root DIR]

Variants (the outputs of all but `full` are wrong by design):
  full         the kernels as they are
  no_exp       the numerators' ex2 (and bf16s_ex2's packed exp) replaced by a
               multiply (no MUFU)
  no_mma       S and PV not issued (no tensor-core work in the loop)
  skeleton     both: loads, barriers and the rest of the softmax
  no_epilogue  K10d: the Wo epilogue skipped (no Wo loads, products or stores)
  tiles_128    K10d: the 128-row tier at every C <= 640 (no 192-row tier)
  tiles_<r>    K1: the full kernel launched with r q rows a CTA in place of
               its plan's (every tier its head dim has)
`--events` instead times whole calls of the wrappers by CUDA events (the
wrapper's host time in them, as chip_smoke.py times them): every K12 mode
at ds1 and the ones kernels at their phase-27 shapes, with the CTAs each
launched; `--root DIR` imports the package from DIR (another checkout,
e.g. the parent commit's, built from its own sources), so two commits are
compared in one call.
Needs the CUDA toolkit and one card; builds into a temporary directory.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if "--root" in sys.argv:
    ROOT = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from minddiffusion_tpu_torch.ops import (_build, attn_diag as ad,  # noqa: E402
                                         attn_variants as av, flash_attention as fa)

EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
EX2_BF16 = '    asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(e) : "r"(bits(hi)));'
S = ("      wgmma_rs<H::KT, 0>(s, qf[kk],\n                         smem_desc(kslot + (kk / 4) * "
     "H::BOX + (kk % 4) * 32, 16, 1024), kk);")
S_MN = "      wgmma_rs<H::KT, 1>(s, qf[kk], smem_desc(kslot + kk * 2048, 1024, 1024), kk);"
PV = ("      wgmma_rs<H::DV, 1>(o, p[kk],\n                         smem_desc(vslot + kk * 2048, "
      "H::VBOX > 1 ? H::BOX : 1024, 1024),\n                         accumulate | kk);")
PV_TF32 = ("      wgmma_tf32_rs_m64n64k8(o, p[kk],\n                             smem_desc(vslot + "
           "(kk / 4) * H::BOX + (kk % 4) * 32, 16, 1024),\n                             "
           "accumulate | kk);")
EPI = "for (int n0 = 0; n0 < c_out; n0 += EPI_N)"
TIER = "return c <= WIDEST_MAX_C && nq >= WIDEST_MIN_NQ ? 192 : c <= WIDE_MAX_C ? 128 : 64;"
CORE = "attn_core.cuh"
NO_EXP = [(CORE, EX2, "  y = x * 0.5f;"), (CORE, EX2_BF16, "    e = bits(hi);")]
NO_MMA = [(CORE, t, "      ;") for t in (S, S_MN, PV, PV_TF32)]
VARIANTS = {   # name: [(file, text, its replacement)], the file attn_core.cuh or the source's
    "full": [],
    "no_exp": NO_EXP,
    "no_mma": NO_MMA,
    "skeleton": NO_EXP + NO_MMA,
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
CUTS = ("full", "no_exp", "no_mma", "skeleton")
DIAG_MODES = {  # K12 variant: (C entry, its mode number, diag_plan's mode, K given as K^T,
    # row tiers timed beside the plan's, `full` only)
    "diag_full": ("mdt_diag", 4, "full", False, ()),
    "diag_kt_full": ("mdt_diag_kt", 4, "full", True, ()),
    "diag_bf16s": ("mdt_diag_bf16s", 0, "bf16s", False, ()),
    "diag_bf16s_ex2": ("mdt_diag_bf16s", 1, "bf16s", False, ()),
    "diag_fp32pv": ("mdt_diag", 3, "fp32pv", False, (64,)),
}
ONES_CASES = [  # (label, B, N, C, exact, ones_mode): K10a / K11 (1) and K10b (2)
    ("ds1_16x4096x320", 16, 4096, 320, False, 1),
    ("ds1_16x4096x320", 16, 4096, 320, False, 2),
    ("ds2_16x1024x640", 16, 1024, 640, False, 1),
    ("ds2_16x1024x640", 16, 1024, 640, False, 2),
    ("ds4_16x256x1280", 16, 256, 1280, True, 1),
]
# --events: the ones wrappers' shapes of chip_smoke.py phase 27 (K10a and
# K10b at ds1 and ds2 raw, K11 at bench_attention.py's three, exact)
EVENT_ONES = [
    ("flash_attention_packed_ones", "ds1_16x4096x320", 16, 4096, 320, False),
    ("flash_attention_packed_ones", "ds2_16x1024x640", 16, 1024, 640, False),
    ("flash_attention_packed_fold", "ds1_16x4096x320", 16, 4096, 320, False),
    ("flash_attention_packed_fold", "ds2_16x1024x640", 16, 1024, 640, False),
    ("ones_attention", "ds1_16x4096x320", 16, 4096, 320, True),
    ("ones_attention", "ds2_16x1024x640", 16, 1024, 640, True),
    ("ones_attention", "ds4_16x256x1280", 16, 256, 1280, True),
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
    """Mean device time in ms of a launch of the kernel `kernel`, which `fn`
    launches once a call, over the launches of `runs` calls that the
    profiler recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # the mean over the launches it recorded: a session may drop some
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in evs)
    count = sum(e.count for e in evs)
    if count < runs:
        print(f"({kernel}: {count} of {runs} launches recorded)", flush=True)
    return total / max(count, 1) / 1000.0


def events_ms(fn, runs: int = 7) -> float:
    """Median CUDA-event ms of a call of `fn` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def sdpa_events_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> float:
    """SDPA's flash backend on (B, H, N, 64) views of packed tensors, by CUDA
    events: the library call the kernels are held against."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    views = [t.view(t.shape[0], t.shape[1], -1, 64).transpose(1, 2) for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return events_ms(lambda: F.scaled_dot_product_attention(*views, scale=scale))


def events(gen: torch.Generator) -> None:
    """Every K12 variant at ds1 and the ones wrappers at EVENT_ONES through
    the package under ROOT, by CUDA events, with the CTAs of each launch;
    SDPA flash beside them (at scale 1 for K12's raw scores)."""
    print(f"events of the package at {ROOT}", flush=True)
    b, n, c = 16, 4096, 320
    q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    print(f"events sdpa_flash_scale1 ds1_16x4096x320 ms {sdpa_events_ms(q, k, v, 1.0):.4f}",
          flush=True)
    for name, (fn, _) in ad.variants().items():
        ms = events_ms(lambda: fn(q, k, v, c // 64))
        ctas = list(getattr(ad, "last_ctas", {}).values())
        print(f"events {name} ds1_16x4096x320 ms {ms:.4f} ctas {ctas[0] if ctas else 'n/a'}",
              flush=True)
    del q, k, v
    for wrapper, label, b, n, c, exact in EVENT_ONES:
        q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        fn = getattr(av, wrapper)
        ms = events_ms(lambda: fn(q, k, v, 0.125, c // 64, exact))
        print(f"events {wrapper} {label} exact={exact} ms {ms:.4f} "
              f"ctas {av.last_ctas['mdt_attn_ones']} sdpa_flash_ms "
              f"{sdpa_events_ms(q, k, v, 0.125):.4f}", flush=True)


def ablate_core_modes(tmp: Path, gen: torch.Generator) -> None:
    """CUTS of K12's DIAG_MODES at ds1 and of the ones kernel at ONES_CASES,
    launched on their plans, device ms each."""
    tmp = tmp / "core_modes"
    tmp.mkdir()
    libs = build(tmp, "attn_diag", CUTS, ad._SIGNATURES)
    b, n, c = 16, 4096, 320
    q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kt = k.transpose(1, 2).contiguous()
    out = torch.empty_like(q)
    work = torch.empty(b, c, n, device="cuda")
    for name, (entry, mode_id, mode, k_mn, tiers) in DIAG_MODES.items():
        rows, stages, groups = ad.diag_plan(mode, b, n, c, c // 64)
        stage = ad._K_TILE * (3 if mode == "fp32pv" else 2)
        row = []
        runs = [(cut, lib, rows, stages) for cut, lib in libs.items()]
        runs += [(f"tiles_{r}", libs["full"], r, fa.ring_stages(c // groups, 64, r, 64, stage))
                 for r in tiers]
        for cut, lib, r, st in runs:
            def call(lib=lib, r=r, st=st):
                err = getattr(lib, entry)(q.data_ptr(), (kt if k_mn else k).data_ptr(),
                                          v.data_ptr(), out.data_ptr(), work.data_ptr(), b, n, c,
                                          c // 64, mode_id, r, st, groups,
                                          torch.cuda.current_stream().cuda_stream, None)
                _build.check(err, f"{name} {cut}")
            row.append(f"{cut} {device_ms(call, 'diag_kernel'):.4f}")
        print(f"{name} ds1_16x4096x320 rows={rows} stages={stages} groups={groups} device ms: "
              + ", ".join(row), flush=True)
    del q, k, v, kt, out, work
    libs = build(tmp, "attn_variants", CUTS, {"mdt_attn_ones": av._SIGNATURES["mdt_attn_ones"]})
    for label, b, n, c, exact, ones_mode in ONES_CASES:
        heads = c // 64
        q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        if ones_mode == av.ONES_FROM_V:
            v = av.augment_v(v, heads)
        out = torch.empty_like(q)
        rows, stages, groups = av.ones_plan(b, n, c, heads)
        row = []
        for cut, lib in libs.items():
            def call(lib=lib):
                err = lib.mdt_attn_ones(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        b, n, n, c, heads, v.shape[-1], ones_mode, 0.125,
                                        int(exact), rows, stages, groups,
                                        torch.cuda.current_stream().cuda_stream, None)
                _build.check(err, f"ones {cut}")
            row.append(f"{cut} {device_ms(call, 'attn_ones_kernel'):.4f}")
        print(f"attn_ones ones_mode={ones_mode} {label} exact={exact} rows={rows} "
              f"stages={stages} groups={groups} device ms: " + ", ".join(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_variants_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--events" in sys.argv:
        events(gen)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        ablate_core_modes(Path(tmp), gen)
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
