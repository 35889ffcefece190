"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (`minddiffusion_tpu_torch`)
beside this folder. Builds the cell's program from the seed, warms up its
shapes (set-up), runs its traffic for --seconds, compares what the timed
path produced with the plain reference, and prints one JSON line last on
standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and last the compared numbers with their limits
(also the last lines on standard error). Exits non-zero without a result
where no card is present, where the cell asks for more cards than there
are, or where the JAX stack or the JAX package was loaded.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Close the part of set-up called `name` (host clock)."""
        self.marks.append((name, time.monotonic()))

    def setup_parts(self) -> dict:
        out, last = {}, self.t0
        for name, t in self.marks:
            out[name] = t - last
            last = t
        return out


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> "NoReturn":  # noqa: F821
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(cell: harness.Cell, outcome: harness.Outcome, trace: bool, device: dict) -> dict:
    records = dict(outcome.records)
    if outcome.trace is not None:
        records["trace"] = outcome.trace
    metrics = {}
    for name in cell.metrics(trace):
        m = harness.metric(name)
        value = m.read(records)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m.UNIT}
    if trace and outcome.trace is not None:
        device = dict(device, busy_s=outcome.trace["busy_s"], window_s=outcome.trace["window_s"])
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        line["breakdown"] = outcome.trace["breakdown"]
    # a number that could not be read (a missing answer) prints as the largest float
    line["checks"] = {n: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": lim}
                      for n, v, lim in outcome.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the port on the card", 2)
    if torch.cuda.device_count() < cell.chips:
        fail(f"cell {cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present", 2)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    kind = harness.traffic_kind(cell.traffic["kind"])
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    ctx.mark("imports")
    outcome = kind.run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        fail(f"forbidden modules loaded: {', '.join(loaded)}", 3)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = result_line(cell, outcome, bool(args.trace), info)
    print("info " + json.dumps(dict(outcome.records.get("info", {}),
                                    memory_peak_bytes=info["memory_peak_bytes"],
                                    setup_parts_s=ctx.setup_parts())), flush=True)
    for name, value, limit in outcome.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
