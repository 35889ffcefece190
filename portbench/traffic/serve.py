"""Serving under open-loop traffic: the program's `BatchingEngine` over an
`SDAdapter` in this process, fed by client threads that submit each
request when it is due, whatever the engine is doing.

Traffic parameters (traffic/<mix>.json, kind "serve"): height, width,
sampler, steps, guidance_scale, batch, max_wait_ms (the engine's), rate
(requests a second), arrival_seed, prompt_chars [least, most],
check_requests (requests
of the window compared with the reference), check_evals, trace_s (how long
a traced run goes on past the window, under the profiler, at the same
load), drain_s (how long past the window's close a request may still
finish).

Arrivals: every seed gets the same schedule, a Poisson process's gaps at
`rate` (the exponential distribution's quantiles, in the order that
`arrival_seed` of the mix draws): the order of the gaps moved the p90 by
up to 10% from seed to seed, against 1% between two runs of one seed, so
the run's seed does not change the load. Each request has a seeded prompt
of letters, read by the stated stand-in tokenizer below (the CLIP BPE's
vocabulary is not in the repository), and a seeded 63-bit request seed,
from which the engine's adapter draws the request's noise.

A request's latency runs from when it was due to its image in the
client's hand; one that fails or does not come counts as missing (an
infinite latency). The comparison takes a seeded sample of the requests
due in the window and follows each, in the batch that carried it, step
by step as the generation cells do (traffic/generate.py), against the
token ids of the stand-in and the noise of the request's seed.
"""
from __future__ import annotations

import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from portbench import counters, sd, weights
from portbench.check import limited
from portbench.harness import Outcome, sub_seed
from portbench.reference import models as ref
from portbench.trace import Segment
from portbench.traffic.generate import Capture, ballast, judge



CLIENT_THREADS = 64


def toy_tokenize(prompt: str, config: dict) -> np.ndarray:
    """The stand-in for the CLIP BPE: bos, each character hashed into
    [1, 49405), eos, zeros to 77. Different prompts get different ids;
    nothing reads them as words."""
    tok = config["tokens"]
    n = config["text"]["context_length"]
    ids = [tok["bos"]] + [(7 * ord(ch) + 3) % 49404 + 1 for ch in prompt][:n - 2] + [tok["eos"]]
    return np.asarray(ids + [tok["pad"]] * (n - len(ids)), np.int32)


def schedule(p: dict, seed: int, seconds: float) -> List[dict]:
    """The requests due in the window: due time, prompt, request seed."""
    n = max(1, int(round(p["rate"] * seconds)))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / p["rate"] for i in range(n)]
    rng = random.Random(p["arrival_seed"])
    rng.shuffle(gaps)
    out, t = [], 0.0
    lo, hi = p["prompt_chars"]
    letters = "abcdefghijklmnopqrstuvwxyz     "
    for i, g in enumerate(gaps):
        t += g
        if t >= seconds:
            break
        r = random.Random(sub_seed(seed, "prompt", i))
        prompt = "".join(r.choice(letters) for _ in range(r.randint(lo, hi))).strip() or "a"
        out.append({"i": i, "due": t, "prompt": prompt,
                    "seed": sub_seed(seed, "request", i)})
    return out


def request_noise(seed: int, shape: tuple) -> np.ndarray:
    """The request's noise as the JAX engine draws it: Philox(seed) normals."""
    return np.random.Generator(np.random.Philox(seed)).standard_normal(shape, np.float32)


class Traced:
    """The harness's wrapper around the engine's adapter: when each request
    was dispatched, and what the program did with the batches that carry a
    sampled request (Capture)."""

    def __init__(self, adapter, capture: Capture, sampled: set):
        self.inner, self.capture, self.sampled = adapter, capture, sampled
        self.dispatched: Dict[int, float] = {}
        self.batches: List[dict] = []

    @property
    def device(self):
        return self.inner.device

    def prepare(self, prompt: str, negative_prompt: str, seed: int) -> dict:
        return dict(self.inner.prepare(prompt, negative_prompt, seed), rid=int(seed))

    def dispatch(self, payloads: list):
        now = time.monotonic()
        rids = [p["rid"] for p in payloads]
        for r in rids:
            self.dispatched.setdefault(r, now)
        cap = None
        if self.sampled & set(rids):
            cap = {"evals": [], "rids": rids}
            self.batches.append(cap)
        self.capture.current = cap
        try:
            return self.inner.dispatch(payloads), cap
        finally:
            self.capture.current = None

    def fetch(self, handle):
        inner, cap = handle
        images = self.inner.fetch(inner)
        if cap is not None:
            cap["images"] = images.copy()
        return images


def build(cell, seed: int, device, sampled: set, mark=lambda name: None):
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline
    from minddiffusion_tpu_torch.serving import BatchingEngine, SDAdapter

    config, p = cell.config, cell.traffic
    state, _ = weights.make(config, seed, device, sd.DTYPES[config["dtype"]])
    mark("weights")
    models = sd.port_models(config, state, device)
    mark("program")
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=p["height"], width=p["width"], num_steps=p["steps"], sampler=p["sampler"],
        guidance_scale=p["guidance_scale"], batch_size=p["batch"])
    f = models.latent_factor
    adapter = SDAdapter(fn, models, lambda s: toy_tokenize(s, config),
                        (p["height"] // f, p["width"] // f))
    traced = Traced(adapter, Capture(models), sampled)
    engine = BatchingEngine(traced, batch_size=p["batch"], max_wait_ms=p["max_wait_ms"])
    return engine, traced, state


def run(ctx) -> Outcome:
    cell, p, seed = ctx.cell, ctx.cell.traffic, ctx.seed
    requests = schedule(p, seed, ctx.seconds)
    rng = random.Random(sub_seed(seed, "check"))
    sample = rng.sample(requests, min(p["check_requests"], len(requests)))
    engine, traced, state = build(cell, seed, ctx.device, {r["seed"] for r in sample}, ctx.mark)
    engine.start()
    # warm-up: a full batch and a partial one behind it, the cell's shapes,
    # the first captured (generate.ballast)
    traced.sampled.add(0)
    with ThreadPoolExecutor(p["batch"] + 1) as pool:
        for f in [pool.submit(engine.submit, f"warm {i}", "", i) for i in range(p["batch"] + 1)]:
            f.result()
    traced.sampled.discard(0)
    if traced.batches:
        ballast(traced.batches[0], p["check_requests"] + 1)
    ctx.mark("warm_batches")
    traced.dispatched.clear()
    traced.batches.clear()
    results: Dict[int, dict] = {}
    lock = threading.Lock()

    def client(req: dict, t0: float) -> None:
        submitted = time.monotonic()
        out = {"submitted": submitted - t0, "image": None}
        try:
            out["image"] = engine.submit(req["prompt"], "", req["seed"],
                                         timeout=ctx.seconds + p["drain_s"])
            out["done"] = time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 -- a failed request counts as missing
            out["error"] = repr(e)
        with lock:
            results[req["i"]] = out

    records: dict = {"config": cell.config, "traffic": p}
    before = (engine.batches_run, engine.requests_served)
    launches = counters.launches()
    # a traced run goes on past the window at the same load for trace_s
    # more, under the profiler: stopping it holds the interpreter for
    # seconds, which would stall the window's own arrivals
    traced_s = p["trace_s"] if ctx.trace else 0.0
    window = [r for r in requests if r["due"] < ctx.seconds]
    later = schedule(p, seed, ctx.seconds + traced_s)[len(window):]
    window_start = time.monotonic()
    records["setup_s"] = window_start - ctx.t0
    pool = ThreadPoolExecutor(CLIENT_THREADS)
    futures, segment = [], None
    for req in window + later:
        if segment is None and req["due"] >= ctx.seconds:
            segment = Segment(sync_inside=False).__enter__()
        delay = window_start + req["due"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        futures.append(pool.submit(client, req, window_start))
    if segment is not None:
        time.sleep(max(0.0, window_start + ctx.seconds + traced_s - time.monotonic()))
        segment.__exit__(None, None, None)
    for f in futures:
        f.result()
    pool.shutdown()
    after = (engine.batches_run, engine.requests_served)
    engine.stop()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    lat, late, waits = [], [], []
    for req in window:
        r = results[req["i"]]
        late.append(r["submitted"] - req["due"])
        lat.append(r["done"] - req["due"] if r.get("image") is not None else math.inf)
        if req["seed"] in traced.dispatched and r.get("image") is not None:
            waits.append(traced.dispatched[req["seed"]] - window_start - r["submitted"])
    records.update(latencies=lat, window_s=ctx.seconds, queue_waits=waits,
                   batch=p["batch"], batches_run=after[0] - before[0],
                   requests_served=after[1] - before[1])
    trace = segment.result if segment is not None else None
    if segment is not None:
        records["segment"] = {"trace": trace}
    records["info"] = {
        "requests": len(window), "failed": sum(1 for x in lat if x == math.inf),
        "generator_late_s_max": max(late), "generator_late_s_median": float(np.median(late)),
        "launches_per_batch": counters.per(launches, counters.launches(), after[0] - before[0]),
        "batches_run": after[0] - before[0]}
    failed = records["info"]["failed"]
    numbers = judge_requests(cell, seed, state, traced, sample, results, ctx.device)
    return Outcome(attempted=len(window), failed=failed, records=records,
                   checks=limited(numbers, cell.cell["limits"]), memory_peak_bytes=peak,
                   trace=trace)


def judge_requests(cell, seed: int, state: dict, traced: Traced, sample: List[dict],
                   results: Dict[int, dict], device, control: bool = False
                   ) -> Dict[str, float]:
    """The comparison over the sampled requests (worst of them). A sampled
    request with no image, or none in a captured batch, is not correct."""
    config, p = cell.config, cell.traffic
    out: Dict[str, float] = {}
    f = 2 ** (len(config["vae"]["ch_mult"]) - 1)
    shape = (p["height"] // f, p["width"] // f, config["vae"]["embed_dim"])
    with torch.no_grad(), ref.fp32_mode():
        for req in sample:
            r = results.get(req["i"], {})
            batch = next((b for b in traced.batches if req["seed"] in b["rids"]), None)
            if r.get("image") is None or batch is None or "images" not in batch:
                out["exact_mismatches"] = out.get("exact_mismatches", 0.0) + 1.0
                continue
            row = batch["rids"].index(req["seed"])
            cap = _row(batch, row, p["batch"])
            cap["images"] = torch.as_tensor(r["image"])[None].to(device)
            cond = torch.as_tensor(toy_tokenize(req["prompt"], config))[None].to(device)
            uncond = torch.as_tensor(toy_tokenize("", config))[None].to(device)
            noise = torch.as_tensor(request_noise(req["seed"], shape))[None].to(device)
            cap["inputs"] = (cond, uncond, noise)
            for name, value in judge(config, p, state, cap, seed, req["i"], control).items():
                out[name] = max(out.get(name, value), value)
    out.setdefault("exact_mismatches", 0.0)
    for name in ("text_rel_l2", "unet_eps_rel_l2", "sampler_rel_l2", "image_rel_l2"):
        out.setdefault(name, math.inf)
    return out


def _row(batch: dict, r: int, b: int) -> dict:
    """One request's rows of a captured batch: its latent row and its
    [uncond; cond] pair at the guidance-folded rows."""
    pair = [r, b + r]
    return {"tokens": batch["tokens"][pair], "ctx": batch["ctx"][pair], "z": batch["z"][r:r + 1],
            "evals": [(x[r:r + 1], t, ctx[pair], eps[pair]) for x, t, ctx, eps in batch["evals"]]}


def calibrate(cell, seeds: List[int], control_seeds: List[int], device) -> List[dict]:
    """Readings over the requests of a short open-loop stretch at the cell's
    load (`calibrate_s` of the mix), sound and of the float8 control."""
    out = []
    p = cell.traffic
    for seed in sorted(set(seeds) | set(control_seeds)):
        requests = schedule(p, seed, p["calibrate_s"])
        sample = requests[:p["check_requests"]]
        engine, traced, state = build(cell, seed, device, {r["seed"] for r in sample})
        engine.start()
        results: Dict[int, dict] = {}
        t0 = time.monotonic()

        def client(req):
            time.sleep(max(0.0, t0 + req["due"] - time.monotonic()))
            results[req["i"]] = {"image": engine.submit(req["prompt"], "", req["seed"])}

        with ThreadPoolExecutor(CLIENT_THREADS) as pool:
            for f in [pool.submit(client, r) for r in requests]:
                f.result()
        engine.stop()
        for side in (["program"] if seed in seeds else []) + \
                    (["control"] if seed in control_seeds else []):
            nums = judge_requests(cell, seed, state, traced, sample, results, device,
                                  control=side == "control")
            out.append({"seed": seed, "side": side, **nums})
        del engine, traced, state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out
