"""Run phase 4 (an SD2 UNet eval: kernel path, under MDT_WINO=0, cfg_fold),
phase 6 (K4 at its sites), phase 7 (txt2img 768x1024), phase 16 (K9
in both modes), phase 17 (K6 in both memory orders), phase 18 (K5 at
ds1, ds2 and ds4, and on the block inputs of an SD2 UNet eval), phase 27
(K10a-d and K11 beside SDPA as dispatched) or phase 31 (the SD2 finetune
step on the process grid: two ranks on the card at dp 2, fsdp 2 and tp 2,
the train CLI under torchrun, and dpm_adaptive txt2img at dp 2) of
chip_smoke.py alone, from this checkout or another one.

    python3 scripts/smoke_phases.py [--root DIR] 4 6 7 16 17 18 27 31

`--root DIR` imports chip_smoke.py and the package from DIR (e.g. the parent
commit, unpacked by `git archive` into `checkout/`), so that two commits are
compared in one call: parent, change, change, parent. Phases 6 and 27
first build every kernel (phase 1, with the ptxas reports their SASS
checks read); phase 6 holds K1's SASS (as phase 2 does), which its
register check reads. Phase 16 runs the GLIDE super-res stage at batch 8
on a seeded random 64 px image (in place of phase 15's cascade output) to
catch K9's inputs. Phases 16, 17 and 18 print each case's kernel ms (CUDA
events around one call) beside its plain version, the unfused chain or the
torch reductions and its bound (and, from a checkout that has them, the
plan, the device ms and the wrapper's host µs). Needs one card; prints
chip_smoke's own lines.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
args = sys.argv[1:]
if "--root" in args:
    i = args.index("--root")
    ROOT = Path(args[i + 1]).resolve()
    del args[i:i + 2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    print(f"chip_smoke phases {args} from {ROOT}", flush=True)
    chip_smoke.phase0()
    for phase in args:
        if phase == "4":
            from minddiffusion_tpu_torch.ops import _build

            for source in ("packed_attention", "winograd"):    # K1 and K2, the eval's
                _build.build(source)
            chip_smoke.phase4(torch.Generator(device="cuda").manual_seed(0))
        elif phase == "27":
            chip_smoke.phase1()
            chip_smoke.phase27(torch.Generator(device="cuda").manual_seed(0),
                               {name: dict(cases=[]) for name in chip_smoke.VARIANT_REPLACES})
        elif phase == "6":
            chip_smoke.phase1()
            chip_smoke.hold_wgmma_sass("packed_attention", chip_smoke.K1_KERNELS, "phase 2",
                                       spills=True)
            chip_smoke.phase6(torch.Generator(device="cuda").manual_seed(0),
                              {"flash_attention": dict(cases=[])})
        elif phase == "7":
            gen = torch.Generator(device="cuda").manual_seed(2)
            chip_smoke.phase7(chip_smoke.sd2_models(gen))
        elif phase == "16":
            gen = torch.Generator(device="cuda").manual_seed(0)
            img64 = torch.randint(0, 256, (chip_smoke.GLIDE_BATCH, 64, 64, 3), generator=gen,
                                  device="cuda", dtype=torch.uint8)
            chip_smoke.phase16(chip_smoke.glide_models(), img64, gen,
                               {"glide_tail": dict(cases=[])})
            torch.cuda.empty_cache()
        elif phase == "17":
            chip_smoke.phase17(torch.Generator(device="cuda").manual_seed(0),
                               {"channel_sums": dict(cases=[])})
        elif phase == "18":
            chip_smoke.phase18(torch.Generator(device="cuda").manual_seed(0),
                               {"fused_ff": dict(cases=[])})
        elif phase == "31":
            import tempfile

            from minddiffusion_tpu_torch.ops import _build

            for source in ("packed_attention", "winograd"):    # K1 and K2, the step's
                _build.build(source)
            with tempfile.TemporaryDirectory() as tmp:
                chip_smoke.phase31(tmp)
        else:
            raise SystemExit(f"smoke_phases: phase {phase} is not 4, 6, 7, 16, 17, 18, 27 "
                             "or 31")
    return 0


if __name__ == "__main__":
    sys.exit(main())
