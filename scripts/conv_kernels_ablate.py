"""Where the time of the two conv kernels goes: K7's GEMM (`conv_gemm_kernel`
in minddiffusion_tpu_torch/ops/csrc/conv3x3.cu) and K8's fused kernel
(`wino43_fused_kernel` in winograd43.cu). Builds copies of the sources with
one piece taken out each and times every copy on the card by
`torch.profiler` (device time only: the mean over the launches it records),
through the wrappers of ops/conv3x3.py and ops/winograd43.py, at the UNet
and VAE shapes of chip_smoke phases 21 and 22. K8's input transform is
timed beside it.

    python3 scripts/conv_kernels_ablate.py

Variants (the outputs of all but `full` are wrong by design):
  full      the kernels as they are
  no_mma    the wgmma products not issued
  no_loads  the TMA loads not issued (the producer arrives on each stage
            without bytes): what the products, barriers and folds cost alone
  no_fold   K8: the output transform's fold of each M not done
  ring_8    K8 with a ring of 8 stages in place of 16
  rs_probe  K8 with A (V) from registers, a constant fragment in place of V
            (wrong by design): the products' cost without A's shared reads
Needs the CUDA toolkit and one card; builds into a temporary directory.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from minddiffusion_tpu_torch.ops import _build, conv3x3 as cv, winograd43 as w43  # noqa: E402

LOADS = [(r"mbar_expect_tx\(([^,;]+), [\w:]+\);", r"mbar_arrive(\1);"),
         (r"tma_load_\w+\([^;]*?\);", ";")]
VARIANTS = {   # source: {variant: [(regex, replacement)]}
    "conv3x3": {"full": [], "no_mma": [(r"wgmma_ss<[^;]*?\);", ";")], "no_loads": LOADS},
    "winograd43": {"full": [], "no_mma": [(r"wgmma_ss_m64n16k16<\d>\([^;]*?\);", ";")],
                   "no_loads": LOADS,
                   "no_fold": [(r"fold<AB - 1>\(prev, tp, yp\);", ";"),
                               (r"fold<35>\(acc1, tp, yp\);", ";")],
                   # the same kernel with half the ring (outputs right)
                   "ring_8": [(r"STAGES = 16;", "STAGES = 8;")],
                   # A from registers (a constant fragment, so wrong), B from
                   # shared memory as in full: what A's shared-memory reads cost
                   "rs_probe": [(r"wgmma_ss_m64n16k16<0>\(cur, smem_desc\([^;]*?\),\s*"
                                 r"(smem_desc\([^;]*?\)),([^;]*?)\);",
                                 r"{ const uint32_t zf[4] = {a, (uint32_t)kk, 0u, 0u}; "
                                 r"wgmma_rs_m64n16k16<0>(cur, zf, \1,\2); }")]},
}
CONV_CASES = [("unet_32x32_640", 16, 32, 32, 640), ("unet_8x8_1280", 16, 8, 8, 1280),
              ("vae_128x128_512", 8, 128, 128, 512), ("vae_512x512_128", 8, 512, 512, 128)]
WINO43_CASES = [("unet_32x32_640", 16, 32, 32, 640, 640),
                ("vae_128x128_512", 8, 128, 128, 512, 512),
                ("vae_512x512_128", 8, 512, 512, 128, 128)]


def build(tmp: Path, source: str, signatures: dict) -> dict:
    """{variant: ctypes library} of csrc/<source>.cu with each variant's
    cuts, one nvcc each, all at once."""
    with ThreadPoolExecutor(len(VARIANTS[source])) as pool:
        libs = pool.map(lambda item: build_one(tmp, source, signatures, *item),
                        VARIANTS[source].items())
        return dict(zip(VARIANTS[source], libs))


def build_one(tmp: Path, source: str, signatures: dict, name: str, cuts) -> ctypes.CDLL:
    """csrc/<source>.cu with `cuts` (regex, replacement pairs), or the file
    at the path `cuts` in its place (another commit's, or a design tried),
    built against this checkout's headers and loaded."""
    d = tmp / f"{source}_{name}"
    d.mkdir()
    for hdr in _build.CSRC.glob("*.cuh"):
        (d / hdr.name).write_text(hdr.read_text())
    if isinstance(cuts, str):
        text, cuts = Path(cuts).read_text(), []
    else:
        text = (_build.CSRC / f"{source}.cu").read_text()
    for pattern, repl in cuts:
        text, n = re.subn(pattern, repl, text, flags=re.S)
        assert n, (source, name, pattern)
    (d / f"{source}.cu").write_text(text)
    out = d / f"lib{source}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(d / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def device_ms(fn, kernel: str, runs: int = 10) -> "float | None":
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in evs)
    count = sum(e.count for e in evs)
    return total / count / 1000.0 if count else None


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_kernels_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as pool:
            conv_job = pool.submit(build, Path(tmp), "conv3x3", cv._SIGNATURES)
            wino_job = pool.submit(build, Path(tmp), "winograd43", w43._SIGNATURES)
            conv_libs, wino_libs = conv_job.result(), wino_job.result()
        for label, b, h, w, c in CONV_CASES:
            x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
            kern = (torch.randn(3, 3, c, c, generator=gen, device="cuda")
                    * (9 * c) ** -0.5).to(torch.bfloat16)
            bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
            flops = 2.0 * b * h * w * 9 * c * c
            row = []
            for name, lib in conv_libs.items():
                with mock.patch.object(_build, "load", lambda *_, lib=lib: lib):
                    ms = device_ms(lambda: cv.conv3x3_pallas(x, kern, bias), "conv_gemm_kernel")
                row.append(f"{name} {fmt(ms)}"
                           + (f" ({flops / ms / 1e9:.1f} TFLOP/s)" if name == "full" and ms
                              else ""))
            print(f"K7 {label} plan={tuple(cv.conv3x3_plan(b, h, w, c, c))} device ms: "
                  + ", ".join(row), flush=True)
        for label, b, h, w, ci, co in WINO43_CASES:
            x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
            kern = torch.randn(3, 3, ci, co, generator=gen, device="cuda") * (9 * ci) ** -0.5
            bias = 0.1 * torch.randn(co, generator=gen, device="cuda")
            u = w43.transform_weights43(kern).to(torch.bfloat16).contiguous()
            flops = 2.0 * 36 * b * (h // 4) * (w // 4) * ci * co
            row = []
            for name, lib in wino_libs.items():
                with mock.patch.object(_build, "load", lambda *_, lib=lib: lib):
                    call = lambda: w43.conv3x3_winograd43(x, kern, bias, u)  # noqa: E731
                    ms = device_ms(call, "wino43_fused_kernel")
                    if name == "full":
                        inp = device_ms(call, "wino43_input_kernel")
                row.append(f"{name} {fmt(ms)}"
                           + (f" ({flops / ms / 1e9:.1f} TFLOP/s of products)"
                              if name == "full" and ms else ""))
            print(f"K8 {label} input_kernel {fmt(inp)}, fused kernel device ms: "
                  + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
