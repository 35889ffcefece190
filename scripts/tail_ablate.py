"""Where K9's and K6's time goes (minddiffusion_tpu_torch/ops/csrc/glide_tail.cu,
gn_stats.cu): builds copies of each source with one piece taken out or
changed and times every copy on the card by `torch.profiler` (device time
only: the mean over the launches it records), through the wrappers' plans
at chip_smoke phases 16 and 17's shapes: K9 "glide" on the GLIDE super-res
features (8, 256, 256, 192) -> 3 and "sd" on the SD2 CFG batch (16, 64, 64,
320) -> 4; K6 at (16, 64, 64, 320) in both memory orders and (16, 16, 16,
1280).

    python3 scripts/tail_ablate.py
    python3 scripts/tail_ablate.py --calls [--root DIR]

`--calls` times instead whole wrapper calls (`glide_tail.tail_step`,
`gn_stats.channel_sums`) of the package under DIR (this checkout's by
default; e.g. the parent commit unpacked by `git archive` into
`checkout/`) at the same shapes: the device ms of every kernel a call
launches, summed, over the calls the profiler recorded, so commits that
launch one kernel or several compare alike.

K9 variants (the outputs of `no_mma` .. `no_epilogue` are wrong by design):
  full       the kernel as it is
  no_mma     the wgmma products not issued
  no_silu    the affine and SiLU not computed (h's bf16 values are written
             back as they are): what the element work's arithmetic costs
  no_mufu    the tanh left out (the affine and the rest kept): what the
             MUFU ops cost
  exp_rcp    tanh as 2 / (1 + exp(-2 y)) - 1: two MUFU ops a value, not one
  no_loads   the TMA loads not issued (the producer arrives on each stage
             without bytes): what the products and the element work cost
             alone
  no_w       the weights' prologue not run (W left as it is in shared
             memory): what the CTA's prologue costs
  no_transform  the element work not done at all (no shared reads or
             writes of the box): the loads, products and epilogue alone
  no_epilogue   Z^T written but no shift-add, no step, no output
  wait0      every box's products waited for before the next box's element
             work: what running them under it hides
  batch8     the loads of eight 16-byte steps in flight, not four
  wg4        four consumer warpgroups of 88 pixels, not three of 120
K6 variants:
  full       the kernel as it is
  unroll8    8 rows' loads in flight a thread, not 4
  no_loads   the rows not read (zeros summed): the launch, the cluster and
             the reductions alone
and `full` on the plan with clusters of 1 (a column block a CTA), 2, 4 and 8.
The build and the profiler's device ms are scripts/conv_kernels_ablate.py's.
Needs the CUDA toolkit and one card; builds into a temporary directory.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
ARGS = sys.argv[1:]
if "--root" in ARGS:
    i = ARGS.index("--root")
    ROOT = Path(ARGS[i + 1]).resolve()
    del ARGS[i:i + 2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the package under ROOT first: conv_kernels_ablate puts this checkout on the path
from minddiffusion_tpu_torch.ops import _build, glide_tail as gt, gn_stats  # noqa: E402
from conv_kernels_ablate import build_one, device_ms, fmt  # noqa: E402

TANH = r"th\[k\] = tanh_fast\(hy\[k\]\);"
TAIL_VARIANTS = {
    "full": [],
    "no_mma": [(r"wgmma_ss_m64n120k16\([^;]*?\);", ";")],
    "no_silu": [(r"const uint32_t in\[4\] = .*?"
                 r"return make_uint4\(o\[0\], o\[1\], o\[2\], o\[3\]\);",
                 "return valid ? v : make_uint4(0u, 0u, 0u, 0u);")],
    "no_mufu": [(TANH, "th[k] = hy[k];")],
    "exp_rcp": [(TANH, "th[k] = __fdividef(2.f, 1.f + __expf(-2.f * hy[k])) - 1.f;")],
    "no_loads": [(r"mbar_expect_tx\(([^,;]+),[^;]*?\);", r"mbar_arrive(\1);"),
                 (r"tma_load_4d\([^;]*?\);", ";")],
    "no_w": [(r"for \(int g0 = tid; g0 < n / 4;", "for (int g0 = n; g0 < n / 4;")],
    "wait0": [(r"wgmma_wait<1>\(\);", "wgmma_wait<0>();")],
    "no_transform": [(r"for \(int i0 = 0; i0 <= STEPS; i0 \+= 4\)",
                      "for (int i0 = STEPS + 1; i0 <= STEPS; i0 += 4)")],
    "no_epilogue": [(r"if \(writes\) \{", "if (false) {")],
    "batch8": [(r"for \(int i0 = 0; i0 <= STEPS; i0 \+= 4\) \{\s*uint4 v\[4\];",
                "for (int i0 = 0; i0 <= STEPS; i0 += 8) { uint4 v[8];"),
               (r"for \(int u = 0; u < 4; \+\+u\)", "for (int u = 0; u < 8; ++u)")],
    "wg4": [(r"constexpr int CONSUMERS = 3;", "constexpr int CONSUMERS = 4;"),
            (r"constexpr int NPIX = 120;", "constexpr int NPIX = 88;"),
            (r"wgmma_ss_m64n120k16\(", "wgmma_ss_m64n88k16(")],
}
STATS_VARIANTS = {
    "full": [],
    "unroll8": [(r"constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")],
    "no_loads": [(r"Load<VEC>::run\([^;]*?\);",
                  "for (int z = 0; z < WORDS; ++z) w[u][z] = (uint32_t)r << 16;")],
}
TAIL_CASES = [("glide_sr_256", (8, 256, 256, 192), 3, "glide"),
              ("sd_cfg_64x64", (16, 64, 64, 320), 4, "sd")]
STATS_CASES = [((16, 64, 64, 320), False), ((16, 64, 64, 320), True),
               ((16, 32, 32, 640), False), ((16, 16, 16, 1280), False),
               ((3, 64, 64, 320), False)]


def tail_operands(gen: torch.Generator, shape, co: int, mode: str) -> list:
    bh, h, w, c = shape
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    bx = bh // 2 if mode == "sd" else bh
    return [rand(bh, h, w, c).to(torch.bfloat16), rand(bx, h, w, co), 1.0 + 0.1 * rand(bh, c),
            0.1 * rand(bh, c), rand(3, 3, c, co) * (9 * c) ** -0.5, 0.1 * rand(co),
            torch.tensor([1.7, 0.9, 0.8, 0.4] if mode == "glide" else [9.0, 1.02, -0.3, 0.0],
                         device="cuda")]


def call_device_ms(fn, runs: int = 10) -> "float | None":
    """Device ms of one call of `fn`: every kernel it launches, summed,
    over the calls torch.profiler recorded (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))]
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in evs)
    # the launches of the call's kernel with the fewest: one a call
    calls = min((e.count for e in evs), default=0)
    return total / calls / 1000.0 if calls else None


def time_calls(gen: torch.Generator) -> None:
    """Whole wrapper calls of the package under ROOT by device ms."""
    print(f"wrapper calls of {Path(gt.__file__).parent}", flush=True)
    with torch.inference_mode():
        for label, shape, co, mode in TAIL_CASES:
            args = tail_operands(gen, shape, co, mode)
            ms = call_device_ms(lambda: gt.tail_step(*args, mode=mode))
            print(f"K9 {label} call device ms {fmt(ms)}", flush=True)
            del args
        for shape, transposed in STATS_CASES:
            x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
            if transposed:
                x = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
            ms = call_device_ms(lambda: gn_stats.channel_sums(x, transposed))
            layout = "hwbc" if transposed else "bhwc"
            print(f"K6 {shape} {layout} call device ms {fmt(ms)}", flush=True)


def build_all(tmp: Path, source: str, signatures: dict, variants: dict) -> dict:
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(
            lambda item: build_one(tmp, source, signatures, *item), variants.items())))


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--calls" in ARGS:
        time_calls(gen)
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as pool:
            tail_libs, stats_libs = pool.map(
                lambda job: build_all(Path(tmp), *job),
                [("glide_tail", gt._SIGNATURES, TAIL_VARIANTS),
                 ("gn_stats", gn_stats._SIGNATURES, STATS_VARIANTS)])
        with torch.inference_mode():
            for label, shape, co, mode in TAIL_CASES:
                args = tail_operands(gen, shape, co, mode)
                plan = gt.tail_plan(shape, co, mode, sms)
                row = []
                for name, lib in tail_libs.items():
                    with mock.patch.object(_build, "load", lambda *_, lib=lib: lib):
                        call = lambda: gt._launch(plan, *args, mode=mode)  # noqa: E731
                        row.append(f"{name} {fmt(device_ms(call, 'tail_kernel'))}")
                print(f"K9 {label} plan={tuple(plan)} device ms: " + "; ".join(row), flush=True)
                del args
            for shape, transposed in STATS_CASES:
                x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                if transposed:
                    x = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
                plan = gn_stats.stats_plan(shape, transposed, sms)
                row = []
                for name, lib in stats_libs.items():
                    with mock.patch.object(_build, "load", lambda *_, lib=lib: lib):
                        call = lambda: gn_stats._run(x, plan)  # noqa: E731
                        row.append(f"{name} {fmt(device_ms(call, 'channel_sums_kernel'))}")
                # the plan at other cluster sizes (1: a column block a CTA,
                # no cluster)
                for cluster in (1, 2, 4, gn_stats.MAX_CLUSTER):
                    other = plan._replace(cluster=cluster, rows_per_cta=-(-plan.rows // cluster),
                                          ctas=plan.ctas // plan.cluster * cluster)
                    call = lambda: gn_stats._run(x, other)  # noqa: E731
                    row.append(f"full at cluster {cluster} "
                               f"{fmt(device_ms(call, 'channel_sums_kernel'))}")
                layout = "hwbc" if transposed else "bhwc"
                print(f"K6 {shape} {layout} plan={tuple(plan)} device ms: " + "; ".join(row),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
