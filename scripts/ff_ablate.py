"""Where K5's time goes (minddiffusion_tpu_torch/ops/csrc/fused_ff.cu): builds
copies of the source with one piece taken out each and times every copy on
the card by `torch.profiler` (device time only: the mean over the launches
it records), kernel by kernel, through ops/fused_ff.py's wrapper at chip_smoke
phase 18's shapes (SD2 512^2 at CFG batch 16: ds1 (16, 4096, 320), ds2 (16,
1024, 640), ds4 (16, 256, 1280), F = 4C), ds1 in both plans (the split
plan H, which `ff_plan` takes above C 320, against the fused plan F).

    python3 scripts/ff_ablate.py [--source NAME=PATH ...]

Variants (the outputs of all but `full` are wrong by design):
  full      the kernels as they are
  no_mma    the wgmma products not issued
  no_loads  the TMA loads not issued (the producer arrives on each stage
            without bytes): what the products, barriers, LN and epilogues
            cost alone
  no_geglu  GEGLU as a + g (no tanh, no cubic): what the activation costs
  no_ln     regime F's LayerNorm not computed (x's rows go to the A tile as
            they are): what the CTA's prologue costs
  ring_half half the stages in each ring (F 7, H's up 2 and down 3; outputs right):
            how much latency the rings hide
  no_p1 / no_p2   F: the first / the second product not issued
  rs_probe  F: the first product with A from registers (a constant
            fragment in place of the LN tile): what A's shared reads cost
`--source NAME=PATH` adds a whole other fused_ff.cu (another commit's, or
a design tried) as one more variant, built against this checkout's
headers and timed in the same call. The build and the profiler's device
ms are scripts/conv_kernels_ablate.py's. Needs the CUDA toolkit and one
card; builds into a temporary directory.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from conv_kernels_ablate import build_one, device_ms, fmt  # noqa: E402
from minddiffusion_tpu_torch.ops import _build, fused_ff as ff  # noqa: E402

VARIANTS = {
    "full": [],
    "no_mma": [(r"wgmma_(?:ss|rs)_m64n\d+k16<0>\([^;]*?\);", ";"),
               (r"wgmma_ss<G::BN, 0>\([^;]*?\);", ";")],
    "no_loads": [(r"mbar_expect_tx\(([^,;]+),[^;]*?\);", r"mbar_arrive(\1);"),
                 (r"tma_load_3d(?:_multicast)?\([^;]*?\);", ";")],
    "no_geglu": [(r"return a \* \(g \* \(0\.5f \* \(1\.f \+ tanh_fast\(inner\)\)\)\);",
                  "return a + g;")],
    "no_ln": [(r"layer_norm<NV>\(v\[rr\], w, b, F_C, eps, row0 \+ r < m, o\);",
               "o[0] = v[rr][0]; o[1] = v[rr][1];")],
    "ring_half": [(r"F_STAGES = \(SMEM_MAX - SLACK - A_BYTES - F_BARS\) / SLOT;",
                   "F_STAGES = 7;"), (r"STAGES = UP \? 4 : 6;", "STAGES = UP ? 2 : 3;")],
    "no_p1": [(r"wgmma_ss_m64n64k16<0>\([^;]*?\);", ";")],
    "no_p2": [(r"wgmma_rs_m64n160k16<0>\([^;]*?\);", ";")],
    "rs_probe": [(r"wgmma_ss_m64n64k16<0>\(acc1, smem_desc\([^;]*?\),\s*(smem_desc\([^;]*?\)),"
                  r"([^;]*?)\);",
                  r"{ const uint32_t zf[4] = {(uint32_t)k, (uint32_t)kk, 0u, 0u}; "
                  r"wgmma_rs_m64n64k16<0>(acc1, zf, \1,\2); }")],
}
# the plan constants each variant builds with (its C entry refuses others)
STAGES = {"ring_half": dict(F_STAGES=7, UP_STAGES=2, DOWN_STAGES=3)}
CASES = [("ds1_16x4096x320", 16, 4096, 320, "F"), ("ds1_16x4096x320", 16, 4096, 320, "H"),
         ("ds2_16x1024x640", 16, 1024, 640, "H"), ("ds4_16x256x1280", 16, 256, 1280, "H")]


def operands(gen: torch.Generator, b: int, n: int, c: int) -> tuple:
    f = 4 * c
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return (rand(b, n, c).to(torch.bfloat16), 1.0 + 0.1 * rand(c), 0.1 * rand(c),
            (rand(2 * f, c) * c ** -0.5).to(torch.bfloat16),
            (0.1 * rand(2 * f)).to(torch.bfloat16),
            (rand(c, f) * f ** -0.5).to(torch.bfloat16), (0.1 * rand(c)).to(torch.bfloat16))


def plan_of(name: str, regime: str, m: int, c: int, f: int) -> "ff.FFPlan":
    """The plan of `regime` with variant `name`'s constants."""
    consts = STAGES.get(name)
    with mock.patch.multiple(ff, **consts) if consts else contextlib.nullcontext():
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return (ff._fused_plan if regime == "F" else ff._split_plan)(m, c, f, sms)


def main() -> int:
    if not torch.cuda.is_available():
        print("ff_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    args = sys.argv[1:]
    variants = dict(VARIANTS)
    while args[:1] == ["--source"]:
        name, path = args[1].split("=", 1)
        variants[name] = str(Path(path).resolve())
        args = args[2:]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(zip(variants, pool.map(
                lambda item: build_one(Path(tmp), "fused_ff", ff._SIGNATURES, *item),
                variants.items())))
        with torch.inference_mode():
            for label, b, n, c, regime in CASES:
                args = operands(gen, b, n, c)
                flops = 6.0 * b * n * c * 4 * c
                row = []
                for name, lib in libs.items():
                    plan = plan_of(name, regime, b * n, c, 4 * c)
                    with mock.patch.object(_build, "load", lambda *_, lib=lib: lib):
                        call = lambda: ff._launch(plan, *args, eps=1e-5)  # noqa: E731
                        parts = {k: device_ms(call, k) for k in ff.KERNELS[regime]}
                    total = (sum(parts.values()) if all(v is not None for v in parts.values())
                             else None)
                    text = f"{name} {fmt(total)}"
                    if len(parts) > 1:
                        text += " (" + " + ".join(f"{k} {fmt(v)}" for k, v in parts.items()) + ")"
                    if name == "full" and total:
                        text += f" {flops / total / 1e9:.1f} TFLOP/s"
                    row.append(text)
                plan = plan_of("full", regime, b * n, c, 4 * c)
                print(f"K5 {label} regime {regime} plan={tuple(plan)} device ms: "
                      + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
