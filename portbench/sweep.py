"""Find the highest rate a serve cell sustains: its open loop at each
given rate for --seconds, in one process on one engine, one line a rate
(p50 / p90 latency, completed requests a second, batch fill, and the
growth of the backlog: the median latency of the last third of the
requests over that of the first third).

    python3 portbench/sweep.py --workload <serve cell> --rates 2,3,4 --seconds 30
"""
import argparse
import json
import math
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.traffic import serve  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=5_000_000_000)
    args = p.parse_args(argv)
    import torch

    cell = harness.resolve(args.workload)
    engine, _, _ = serve.build(cell, args.seed, torch.device("cuda"), set())
    engine.start()
    for i in range(cell.traffic["batch"] + 1):
        engine.submit(f"warm {i}", "", i)
    for rate in [float(r) for r in args.rates.split(",")]:
        reqs = serve.schedule(dict(cell.traffic, rate=rate), args.seed + int(rate * 1000),
                              args.seconds)
        b0, s0 = engine.batches_run, engine.requests_served
        done = {}
        t0 = time.monotonic()

        def client(req):
            time.sleep(max(0.0, t0 + req["due"] - time.monotonic()))
            engine.submit(req["prompt"], "", req["seed"])
            done[req["i"]] = time.monotonic() - t0 - req["due"]

        with ThreadPoolExecutor(serve.CLIENT_THREADS) as pool:
            for f in [pool.submit(client, r) for r in reqs]:
                f.result()
        wall = time.monotonic() - t0
        lat = [done[r["i"]] for r in reqs]
        third = max(1, len(lat) // 3)
        runs = engine.batches_run - b0
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "completed_per_s": len(reqs) / wall,
            "p50_s": statistics.median(lat),
            "p90_s": sorted(lat)[math.ceil(0.9 * len(lat)) - 1],
            "fill": (engine.requests_served - s0) / max(1, runs * cell.traffic["batch"]),
            "backlog_growth": statistics.median(lat[-third:]) / statistics.median(lat[:third]),
            "drain_s": wall - args.seconds}), flush=True)
    engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
