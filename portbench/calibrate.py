"""Readings of a cell's comparison on many seeds, for setting its limits:
sound runs of the program, and the lower-precision control (the reference
in float8) in the program's place, at the cell's own sizes.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 [--first N]
    python3 portbench/calibrate.py --workload <cell> --seeds 3 --fault half_batch

One JSON line a seed and side, then the largest program reading and the
smallest control reading of each number. On the card; `--device cpu` runs
a test-size cell from `--base`.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first", type=int, default=7_000_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--base", default=str(harness.BENCH))
    p.add_argument("--fault", default=None,
                   help="a fault of portbench/faults.py planted in the program's runs")
    args = p.parse_args(argv)
    import torch

    cell = harness.resolve(args.workload, Path(args.base))
    device = torch.device(args.device)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    control = seeds[:args.control]
    t0 = time.monotonic()
    kind = harness.traffic_kind(cell.traffic["kind"])
    if args.fault:
        from portbench.faults import FAULTS

        with FAULTS[args.fault]():
            rows = kind.calibrate(cell, seeds, [], device)
        for r in rows:
            r["side"] = args.fault
    else:
        rows = kind.calibrate(cell, seeds, control, device)
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min), (args.fault, min)):
        vals = [r for r in rows if r["side"] == side]
        if vals:
            keys = [k for k in vals[0] if k not in ("seed", "side")]
            summary[side] = {k: pick(r[k] for r in vals) for k in keys}
    print(json.dumps({"workload": args.workload, "seconds": time.monotonic() - t0,
                      "largest_program": summary.get("program"),
                      "smallest_control": summary.get("control"),
                      "smallest_fault": summary.get(args.fault)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
