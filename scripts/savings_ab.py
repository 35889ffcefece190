"""Time the two sampling savings (CFG-prefix dedup, the K/V hoist) on and
off on the card, in turns, on the paths they touch.

    python3 scripts/savings_ab.py [--rounds 3] [sd2_512 sd2_768x1024 glide sd2_serve]

sd2_512 is the main path (SD2 txt2img 512^2, DDIM-50, CFG 9.0, batch 8),
sd2_768x1024 the same at 768x1024 batch 4, glide the cascade at batch 8,
sd2_serve one batch of 8 requests through the SD2 serving engine at the
main path's config (chip_smoke.py's models, seeds and prompts, and its
engine from `cli/serve._build_sd_engine`; the first three run by
default). The SD paths run chip_smoke's SAVINGS ("on": the defaults;
"off": MDT_CFG_DEDUP=0 MDT_HOIST=wino; "dedup" and "hoist": one saving
alone), GLIDE the MDT_HOIST values 1, wino, kv and 0. Each round runs
every setting once, in forward order on even rounds and reversed on odd
ones, after one warm run each; a line per setting gives the
host-clock seconds of each run (the device synchronised) and their median
(for GLIDE also each stage's median); one more run of each under
torch.profiler (CUDA activity only) gives the device's busy ms (kernels and
copies, overlaps merged) and its idle share over the run. Needs one card;
imports chip_smoke.py from this checkout.
"""
from __future__ import annotations

import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SD_PATHS = {"sd2_512": (512, 512, 8), "sd2_768x1024": (768, 1024, 4)}
GLIDE_HOIST = ("1", "wino", "kv", "0")


def busy_ms(fn) -> "tuple[float, float]":
    """(device busy ms, idle share) of one `fn()` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    busy, run_start, run_end = 0, acts[0][0], acts[0][1]
    for s, e in acts[1:]:
        if s > run_end:
            busy += run_end - run_start
            run_start, run_end = s, e
        else:
            run_end = max(run_end, e)
    busy += run_end - run_start
    return busy / 1e6, 1.0 - busy / (acts[-1][1] - acts[0][0])


def ab(label: str, settings: dict, run, rounds: int) -> None:
    """Host seconds of `run(name)` under each setting (name: a function
    returning its flag context) in turns, then device busy ms."""
    secs = {name: [] for name in settings}
    for name, env in settings.items():          # warm-up
        with env():
            run(name)
    for r in range(rounds):
        order = list(settings) if r % 2 == 0 else list(reversed(settings))
        for name in order:
            with settings[name]():
                t0 = time.time()
                run(name)
                torch.cuda.synchronize()
                secs[name].append(time.time() - t0)
    for name, env in settings.items():
        with env():
            busy, idle = busy_ms(lambda: run(name))
        print(f"[savings_ab] {label} {name}: s_per_batch "
              f"median={statistics.median(secs[name]):.4f} "
              f"runs={','.join(f'{x:.4f}' for x in secs[name])} device_busy_ms={busy:.1f} "
              f"idle_share={idle:.4f}", flush=True)


def sd_path(label: str, rounds: int) -> None:
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    height, width, batch = SD_PATHS[label]
    models = cs.sd2_models(torch.Generator(device="cuda").manual_seed(1))
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=height, width=width, num_steps=50, sampler="ddim", guidance_scale=9.0,
        batch_size=batch)
    tokens = torch.ones(batch, 77, dtype=torch.long)
    uncond = torch.zeros(batch, 77, dtype=torch.long)
    settings = {name: (lambda name=name: cs.savings(name)) for name in cs.SAVINGS}
    ab(label, settings, lambda name: fn(models, tokens, uncond,
                                        torch.Generator(device="cuda").manual_seed(7)), rounds)
    del models
    torch.cuda.empty_cache()


def sd2_serve(rounds: int) -> None:
    from minddiffusion_tpu_torch.cli import serve

    engine, _ = serve._build_sd_engine(
        cs.serve_args(["--family", "sd2", "--batch_size", str(cs.SERVE_BATCH)]),
        cs.toy_tokenize)
    engine.start()
    n = cs.SERVE_BATCH

    def run(name):
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(lambda i: engine.submit(f"load {i}", "", 3000 + i, timeout=600),
                          range(n)))

    try:
        ab("sd2_serve_b8", {name: (lambda name=name: cs.savings(name)) for name in cs.SAVINGS},
           run, rounds)
    finally:
        engine.stop()
    del engine
    torch.cuda.empty_cache()


def glide(rounds: int) -> None:
    from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideCascadePipeline

    models = cs.glide_models()
    b, xf = cs.GLIDE_BATCH, models.base.xf_config
    fn = GlideCascadePipeline(models).build_generate(batch_size=b)
    tokens, mask = cs.glide_tokens(b, xf.text_ctx, xf.n_vocab)
    stages: dict = {}

    def run(name):
        secs: dict = {}
        fn(models, tokens, mask, torch.Generator(device="cuda").manual_seed(13), timings=secs)
        for k, v in secs.items():
            stages.setdefault(name, {}).setdefault(k, []).append(v)

    settings = {value: (lambda value=value: cs.flag_env(MDT_HOIST=value))
                for value in GLIDE_HOIST}
    ab("glide_b8 MDT_HOIST", settings, run, rounds)
    for value, by_stage in stages.items():     # the timed runs: not the first or last
        print(f"[savings_ab] glide_b8 MDT_HOIST {value}: stage medians " + " ".join(
            f"{k}_s={statistics.median(v[1:-1]):.4f}" for k, v in by_stage.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("savings_ab: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    rounds = 3
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    cs.phase0()
    for path in args or ["sd2_512", "sd2_768x1024", "glide"]:
        if path in SD_PATHS:
            sd_path(path, rounds)
        elif path == "glide":
            glide(rounds)
        elif path == "sd2_serve":
            sd2_serve(rounds)
        else:
            raise SystemExit(f"savings_ab: unknown path {path!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
