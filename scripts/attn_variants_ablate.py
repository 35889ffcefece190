"""Where the time of K10d's kernel (`mdt_attn_out` in
minddiffusion_tpu_torch/ops/csrc/attn_variants.cu) goes: builds copies of
the source with one piece taken out each and times every copy on the card
at the SD2 UNet's ds1 and ds2 shapes and K11's ds4 one, by
`torch.profiler` (device time only, no host overhead). Then times K10c's
first launch, the projection GEMM (`mdt_qkv_proj`), alone on the device at
K10c's ds1 and ds2 shapes.

    python3 scripts/attn_variants_ablate.py

Variants (the outputs of all but `full` are wrong by design):
  full         the kernel as it is
  no_exp       the numerators' ex2 replaced by a multiply (no MUFU)
  no_mma       S and PV not issued (no tensor-core work in the loop)
  skeleton     both: loads, barriers and the rest of the softmax
  no_epilogue  the Wo epilogue skipped (no Wo loads, products or stores)
  tiles_128    the 128-row tier at every C <= 640 (no 192-row tier)
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

from minddiffusion_tpu_torch.ops import _build, attn_variants as av  # noqa: E402

EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
S = "    wgmma_rs_m64n64k16<0>(s, qf[kk], smem_desc(kbox + kk * 32, 16, 1024), kk);"
PV = ("    wgmma_rs_m64n64k16<1>(o, p[kk], smem_desc(vbox + kk * 2048, 1024, 1024), "
      "accumulate | kk);")
EPI = "for (int n0 = 0; n0 < c_out; n0 += EPI_N)"
TIER = "return c <= WIDEST_MAX_C && nq >= WIDEST_MIN_NQ ? 192 : c <= WIDE_MAX_C ? 128 : 64;"
VARIANTS = {
    "full": [],
    "no_exp": [(EX2, "  y = x * 0.5f;")],
    "no_mma": [(S, "    ;"), (PV, "    ;")],
    "skeleton": [(EX2, "  y = x * 0.5f;"), (S, "    ;"), (PV, "    ;")],
    "no_epilogue": [(EPI, "for (int n0 = 0; n0 < 0; n0 += EPI_N)")],
    "tiles_128": [(TIER, "return c <= WIDE_MAX_C ? 128 : 64;")],
}
CASES = [  # (label, B, N, C, exact): self-attention, C_out = C
    ("ds1_16x4096x320", 16, 4096, 320, False),
    ("ds2_16x1024x640", 16, 1024, 640, False),
    ("ds2_16x1024x640", 16, 1024, 640, True),
    ("ds4_16x256x1280", 16, 256, 1280, True),
]
GEMM_CASES = [  # (label, B, N, C): K10c's x @ [Wq | Wk | Wv], M = B N, N = 3C, K = C
    ("ds1_16x4096x320", 16, 4096, 320),
    ("ds2_16x1024x640", 16, 1024, 640),
]


def build(tmp: Path) -> dict:
    src = (_build.CSRC / "attn_variants.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old.strip()!r}")
            text = text.replace(old, new)
        path = tmp / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(tmp / f"lib{name}.so"), str(path)], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr.read()}")
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        for entry in ("mdt_attn_out", "mdt_qkv_proj"):
            getattr(lib, entry).argtypes = av._SIGNATURES[entry]
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
        libs = build(Path(tmp))
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
