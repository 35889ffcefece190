"""Bulk text-to-image generation: a closed loop of back-to-back calls of the
program's txt2img pipeline (`StableDiffusionPipeline.build_txt2img`), each
batch dispatched before the previous batch's uint8 images are fetched
(pinned host memory and an event, as the serving engine does).

Traffic parameters (traffic/<mix>.json, kind "generate"): height, width,
sampler ("ddim" or "dpm"), steps, guidance_scale, batch, prompt_tokens
[least, most] (the prompt's length in token ids), check_batches (batches
of the window compared with the reference), check_evals (UNet evaluations
of each compared batch run again by the reference), trace_batches
(batches in the traced segment).

Records: the window's batch completions, and in a traced run the segment,
its batches and each UNet evaluation's host and device milliseconds.

The comparison, once the window has closed and the program is freed,
follows each compared batch step by step from the program's own state:
the text encoder on the batch's token ids; the UNet at `check_evals`
evaluations (the first, the last and seeded others) on the latents, time
and context the program's UNet was given; every sampler update (guidance,
then DDIM or DPM-Solver++ 2M) from the state and the UNet outputs the
program had; the VAE decode of the program's final latent, to uint8. The
start of the chain (token ids, noise, model times, evaluation count) is
held exactly.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import counters, sd, weights
from portbench.check import limited, row_rel
from portbench.harness import Outcome, sub_seed
from portbench.reference import models as ref
from portbench.reference import samplers as ref_samplers
from portbench.reference.quant import fp8
from portbench.trace import Segment


class Capture:
    """Forward hooks that keep, for the batch being dispatched, what the
    program's text encoder, UNet and VAE decoder were given and gave."""

    def __init__(self, models):
        self.current: Optional[dict] = None
        self.timing: Optional[list] = None       # [(host_s, start event, end event)]
        self._handles = [
            models.text_encoder.register_forward_hook(self._text),
            models.unet.register_forward_pre_hook(self._unet_pre),
            models.unet.register_forward_hook(self._unet, with_kwargs=True),
            models.vae.post_quant_conv.register_forward_pre_hook(self._decode)]

    def _text(self, module, args, out):
        if self.current is not None:
            self.current["tokens"], self.current["ctx"] = args[0], out

    def _unet_pre(self, module, args):
        if self.timing is not None:
            ev = torch.cuda.Event(enable_timing=True) if torch.cuda.is_available() else None
            if ev is not None:
                ev.record()
            self._open = (time.perf_counter(), ev)

    def _unet(self, module, args, kwargs, out):
        if self.timing is not None:
            t0, ev0 = self._open
            ev1 = None
            if ev0 is not None:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
            self.timing.append((time.perf_counter() - t0, ev0, ev1))
        if self.current is not None:
            x, t = args[0], args[1]
            ctx = args[2] if len(args) > 2 else kwargs.get("context")
            self.current["evals"].append((x, t, ctx, out))

    def _decode(self, module, args):
        if self.current is not None:
            self.current["z"] = args[0]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class Loop:
    """The program's pipeline with one batch in flight."""

    def __init__(self, cell, seed: int, device, state=None, marks=None):
        from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

        mark = marks or (lambda name: None)
        self.config, self.p, self.seed, self.device = cell.config, cell.traffic, seed, device
        if state is None:
            state, _ = weights.make(self.config, seed, device, sd.DTYPES[self.config["dtype"]])
            mark("weights")
        models = sd.port_models(self.config, state, device)
        mark("program")
        self.models, self.state = models, state
        p = self.p
        self.fn = StableDiffusionPipeline(models).build_txt2img(
            height=p["height"], width=p["width"], num_steps=p["steps"], sampler=p["sampler"],
            guidance_scale=p["guidance_scale"], batch_size=p["batch"])
        self.gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "sampler"))
        self.capture = Capture(models)
        self.kept: Dict[int, dict] = {}
        self.keep = p["check_batches"]

    def inputs(self, k: int):
        b = self.p["batch"]
        cond, uncond = sd.prompt_tokens(self.config, self.p, self.seed, k, b, self.device)
        return cond, uncond, sd.latent_noise(self.config, self.p, self.seed, k, b, self.device)

    def priority(self, k: int) -> int:
        return sub_seed(self.seed, "check", k)

    def dispatch(self, k: int):
        cond, uncond, noise = self.inputs(k)
        # keep the captures of the highest-priority batches (one more for the one in flight)
        kept = sorted(self.kept, key=self.priority)
        if len(kept) <= self.keep or self.priority(k) > self.priority(kept[0]):
            self.capture.current = self.kept[k] = {"evals": [], "inputs": (cond, uncond, noise)}
            while len(self.kept) > self.keep + 1:
                del self.kept[min(self.kept, key=self.priority)]
        images = self.fn(self.models, cond, uncond, self.gen, noise=noise)
        self.capture.current = None
        if images.device.type != "cuda":
            return k, images, None
        host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        host.copy_(images, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return k, host, event

    def fetch(self, handle) -> float:
        k, host, event = handle
        if event is not None:
            event.synchronize()
        if k in self.kept:
            self.kept[k]["images"] = host.clone()
        return time.monotonic()

    def checked(self, completed: List[int]) -> List[int]:
        done = [k for k in completed if k in self.kept and "images" in self.kept[k]]
        return sorted(sorted(done, key=self.priority)[-self.keep:])

    def release(self) -> None:
        """Free the program's state; keep the captures and the weights."""
        self.capture.remove()
        self.models = self.fn = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def ballast(cap: dict, copies: int) -> None:
    """Grow the allocator's cache by `copies` of a batch's captures, freed at
    once, so that the captures kept in the window are served from it and
    no allocation reaches cudaMalloc there."""
    tensors = [t for ev in cap["evals"] for t in ev if isinstance(t, torch.Tensor)]
    held = [torch.empty_like(t) for t in tensors for _ in range(copies)]
    del held


def _drain(loop: Loop, pending: list, completions: list, record: bool) -> None:
    while pending:
        handle = pending.pop(0)
        t = loop.fetch(handle)
        if record:
            completions.append((handle[0], t))


def run(ctx) -> Outcome:
    cell, p = ctx.cell, ctx.cell.traffic
    loop = Loop(cell, ctx.seed, ctx.device, marks=ctx.mark)
    # warm-up: the cell's own shapes, one batch (kernel builds, first launches)
    pending = [loop.dispatch(-1)]
    _drain(loop, pending, [], False)
    ballast(loop.kept.pop(-1), loop.keep + 1)
    ctx.mark("warm_batch")
    completions: list = []
    records: dict = {"config": cell.config, "traffic": p, "batch": p["batch"]}
    segment = None
    launches = counters.launches()
    window_start = time.monotonic()
    records["setup_s"] = window_start - ctx.t0
    k = 0
    while True:
        pending.append(loop.dispatch(k))
        k += 1
        if len(pending) > 1:
            handle = pending.pop(0)
            t = loop.fetch(handle)
            completions.append((handle[0], t))
            if t - window_start >= ctx.seconds:
                break
            if ctx.trace and segment is None:
                segment = _traced_segment(loop, pending, completions, k, p["trace_batches"])
                k += p["trace_batches"]
                records["segment"] = segment
    window_end = completions[-1][1]
    _drain(loop, pending, [], False)
    records["info"] = {"launches_per_batch": counters.per(launches, counters.launches(), k),
                       "batches_completed": len(completions)}
    records["window_s"] = window_end - window_start
    records["completions"] = [t - window_start for _, t in completions]
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    checked = loop.checked([j for j, _ in completions])
    loop.release()
    numbers = judge_batches(loop, checked)
    attempted = p["batch"] * len(completions)
    return Outcome(attempted=attempted, failed=0, records=records,
                   checks=limited(numbers, cell.cell["limits"]), memory_peak_bytes=peak,
                   trace=None if segment is None else segment["trace"])


def _traced_segment(loop: Loop, pending: list, completions: list, k: int, n: int) -> dict:
    """Drain, then `n` batches under the profiler with one in flight."""
    _drain(loop, pending, completions, True)
    loop.capture.timing = []
    with Segment() as seg:
        inner: list = []
        for j in range(k, k + n):
            inner.append(loop.dispatch(j))
            if len(inner) > 1:
                h = inner.pop(0)
                completions.append((h[0], loop.fetch(h)))
        _drain(loop, inner, completions, True)
    timing = loop.capture.timing
    loop.capture.timing = None
    evals = [(host * 1e3, ev0.elapsed_time(ev1) if ev0 is not None else None)
             for host, ev0, ev1 in timing]
    return {"trace": seg.result, "batches": n, "unet_evals": evals}


# ---- the comparison ----------------------------------------------------------


def judge_batches(loop: Loop, batches: List[int], control: bool = False) -> Dict[str, float]:
    """The comparison's numbers over the compared batches (worst of them).
    `control`: the reference in float8 (reference/quant.py) in the
    program's place, given what the program was given."""
    out: Dict[str, float] = {}
    with torch.no_grad(), ref.fp32_mode():
        for k in batches:
            for name, value in judge(loop.config, loop.p, loop.state, loop.kept[k],
                                     loop.seed, k, control).items():
                out[name] = max(out.get(name, value), value)
    if not batches:
        out = {"exact_mismatches": float("inf")}
    return out


def _eval_steps(p: dict, seed: int, k: int) -> List[int]:
    s = p["steps"]
    rest = list(range(1, s - 1))
    random.Random(sub_seed(seed, "evals", k)).shuffle(rest)
    return sorted({0, s - 1, *rest[:max(0, p["check_evals"] - 2)]})


def judge(config: dict, p: dict, params: dict, cap: dict, seed: int, k: int,
          control: bool = False) -> Dict[str, float]:
    q: Optional[Callable] = fp8 if control else None
    cond, uncond, noise = cap["inputs"]
    b = cond.shape[0]
    tok2 = torch.cat([uncond, cond])
    evals = cap["evals"]
    sched = config["schedule"]
    times, update = ref_samplers.steps(p["sampler"], p["steps"], sched["timesteps"],
                                       sched["linear_start"], sched["linear_end"])
    exact = 0.0
    exact += float(cap["tokens"].shape != tok2.shape or
                   not torch.equal(cap["tokens"].to(tok2.device).long(), tok2.long()))
    exact += float(len(evals) != p["steps"])
    if exact:
        return {"exact_mismatches": exact, "text_rel_l2": float("inf"),
                "unet_eps_rel_l2": float("inf"), "sampler_rel_l2": float("inf"),
                "image_rel_l2": float("inf")}
    xs = [x[:b].float() for x, _, _, _ in evals]
    exact += float(not torch.equal(xs[0], noise.float()))
    exact += sum(float(t.reshape(-1).float()[0].item() != times[i])
                 or float(t.numel() != 1 and not bool((t == t.reshape(-1)[0]).all()))
                 for i, (_, t, _, _) in enumerate(evals))
    # text encoder
    ctx_ref = ref.text_encoder(params, config["text"], tok2)
    ctx_got = ref.text_encoder(params, config["text"], tok2, q) if control else cap["ctx"]
    text = row_rel(ctx_got, ctx_ref)
    # UNet at the chosen evaluations, on what the program's UNet was given
    unet = 0.0
    for i in _eval_steps(p, seed, k):
        x, t, ctx, eps = evals[i]
        x2 = torch.cat([xs[i], xs[i]])
        t2 = t.reshape(-1).expand(2 * b) if t.numel() == 1 else t
        want = ref.unet(params, config["unet"], x2, t2, ctx.float())
        got = ref.unet(params, config["unet"], x2, t2, ctx.float(), q) if control else eps
        unet = max(unet, row_rel(got, want))
    # every sampler update, from the program's state and UNet outputs
    scale = p["guidance_scale"]
    rd = (lambda t: q(t).double()) if control else (lambda t: t.double())
    eps_g = [ref_samplers.guide(e.float(), scale) for _, _, _, e in evals]
    eps_q = [rd(e) for e in eps_g]
    xs_q = [rd(x) for x in xs]
    sf = config["scale_factor"]
    z_got = cap["z"].float()
    sampler = 0.0
    for i in range(p["steps"]):
        want = update(i, [x.double() for x in xs], eps_g)
        got = update(i, xs_q, eps_q)
        if i + 1 < p["steps"]:
            nxt = got if control else xs[i + 1]
            sampler = max(sampler, row_rel(nxt, want))
        else:
            dt = sd.DTYPES[config["dtype"]]
            want_z = (want / sf).float().to(dt).float()
            got_z = (got / sf).float().to(dt).float() if control else z_got
            sampler = max(sampler, row_rel(got_z, want_z))
    # VAE decode of the program's final latent, to uint8
    image = 0.0
    for r in range(0, b, 2):
        want = _to_uint8(ref.vae_decode(params, config["vae"], z_got[r:r + 2]))
        got = (_to_uint8(ref.vae_decode(params, config["vae"], z_got[r:r + 2], q)) if control
               else cap["images"][r:r + 2])
        image = max(image, row_rel(got.float(), want.float(), center=127.5))
    return {"exact_mismatches": exact, "text_rel_l2": text, "unet_eps_rel_l2": unet,
            "sampler_rel_l2": sampler, "image_rel_l2": image}


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp((img.float() + 1.0) * 127.5, 0.0, 255.0)).to(torch.uint8)


def calibrate(cell, seeds: List[int], control_seeds: List[int], device) -> List[dict]:
    """The comparison's readings of sound runs (each seed: its weights, the
    timed path's pipeline over `check_batches` batches one in flight) and,
    on `control_seeds`, of the float8 control in the program's place."""
    out, loop = [], None
    for seed in sorted(set(seeds) | set(control_seeds)):
        state, _ = weights.make(cell.config, seed, device, sd.DTYPES[cell.config["dtype"]])
        if loop is None:
            loop = Loop(cell, seed, device, state=state)
        else:
            with torch.no_grad():
                for kind, module in loop.models.modules().items():
                    pre = ref.PREFIX[kind]
                    module.load_state_dict({n[len(pre):]: v for n, v in state.items()
                                            if n.startswith(pre)}, strict=True)
            loop.state, loop.seed, loop.kept = state, seed, {}
        pending = []
        for k in range(loop.keep):
            pending.append(loop.dispatch(k))
        for h in pending:
            loop.fetch(h)
        batches = list(range(loop.keep))
        if seed in seeds:
            out.append({"seed": seed, "side": "program", **judge_batches(loop, batches)})
        if seed in control_seeds:
            out.append({"seed": seed, "side": "control",
                        **judge_batches(loop, batches, control=True)})
    return out
