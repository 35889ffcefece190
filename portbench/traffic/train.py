"""Full UNet fine-tuning: a closed loop of the program's train step
(`make_train_step(TrainConfig)(state, batch, seed, draws)` on the state of
`create_train_state`), fp32 master weights under bf16 compute, the
optimizer and schedule of the configuration's "train" entry.

Traffic parameters (traffic/<mix>.json, kind "train"): image_size, batch,
prompt_tokens [least, most], check_steps (the first steps the reference
follows), trace_steps (steps in the traced segment).

Every step's batch is new and made on the device from the seed: images
uniform in [-1, 1], caption token ids, and the step's draws (t, the
latent noise, the posterior noise), which the program is handed. Set-up
builds one train state and drives it through the first `check_steps`
steps, which also warm up every shape; the window goes on with the same
state. Its loss is fetched only after the window.

The comparison follows those first steps with the plain reference from
the same weights and batches: each step's loss; the first step's clipped
gradient as the optimizer got it (AdamW's first moment / (1 - beta1));
the parameters' change over the steps. Gradient and change are taken leaf
by leaf as the gap between the norms, against the larger of the
reference's norm of that leaf and of the median leaf; leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from portbench import counters, sd, weights
from portbench.check import limited
from portbench.harness import Outcome, sub_seed
from portbench.reference import models as ref
from portbench.reference.quant import fp8
from portbench.reference.train import Trainer
from portbench.trace import Segment

SMALL_LEAF = 1e-3


def batch_of(config: dict, p: dict, seed: int, k: int, device) -> tuple:
    """Step k's batch and draws, made on the device from the seed."""
    b, size = p["batch"], p["image_size"]
    f = 2 ** (len(config["vae"]["ch_mult"]) - 1)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "train", k))
    image = torch.rand((b, size, size, 3), generator=gen, device=device) * 2.0 - 1.0
    tokens, _ = sd.prompt_tokens(config, p, seed, f"train-{k}", b, device)
    lat = (b, size // f, size // f, config["vae"]["embed_dim"])
    draws = {"t": torch.randint(0, config["schedule"]["timesteps"], (b,), generator=gen,
                                device=device),
             "noise": torch.randn(lat, generator=gen, device=device),
             "enc_noise": torch.randn(lat, generator=gen, device=device)}
    return {"image": image, "tokens": tokens}, draws


class Program:
    """The program's train state and step, with what the check keeps."""

    def __init__(self, config: dict, p: dict, seed: int, device, mark=lambda name: None):
        from minddiffusion_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                           make_train_step)

        self.config, self.p, self.seed, self.device = config, p, seed, device
        self.params, _ = weights.make(config, seed, device, torch.float32)
        mark("weights")
        models = sd.port_models(config, self.params, device, param_dtype=torch.float32)
        tc = config["train"]
        self.tc = TrainConfig(
            start_lr=tc["start_lr"], end_lr=tc["end_lr"], warmup_steps=tc["warmup_steps"],
            decay_steps=tc["decay_steps"], beta1=tc["beta1"], beta2=tc["beta2"],
            weight_decay=tc["weight_decay"], max_grad_norm=tc["max_grad_norm"],
            trainable=tc["trainable"])
        self.state = create_train_state(models, self.tc)
        self.step_fn = make_train_step(self.tc)
        mark("program")
        self.metrics: List[dict] = []
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}

    def step(self, k: int) -> dict:
        batch, draws = batch_of(self.config, self.p, self.seed, k, self.device)
        m = self.step_fn(self.state, batch, self.seed, draws)
        self.metrics.append(m)
        return m

    def warm(self) -> None:
        """The first check_steps steps, keeping what the check compares."""
        opt = self.state.optimizer
        for k in range(self.p["check_steps"]):
            self.step(k)
            if k == 0:
                b1 = self.tc.beta1
                moments = opt.torch_optimizer.state
                # a parameter the optimizer did not step has no moment: zero
                self.first_grad = {n: moments[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - b1)
                                   for n, p in opt.params.items()}
        self.after = {n: p.detach().clone() for n, p in opt.params.items()}

    def release(self) -> None:
        self.state = self.step_fn = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Outcome:
    cell, p = ctx.cell, ctx.cell.traffic
    prog = Program(cell.config, p, ctx.seed, ctx.device, ctx.mark)
    prog.warm()
    _sync(ctx.device)
    ctx.mark("first_steps")
    records: dict = {"config": cell.config, "traffic": p, "batch": p["batch"]}
    launches = counters.launches()
    window_start = time.monotonic()
    records["setup_s"] = window_start - ctx.t0
    k, segment = p["check_steps"], None
    while True:
        prog.step(k)
        k += 1
        if ctx.trace and segment is None:
            segment = _traced_segment(prog, ctx.device, k, p["trace_steps"])
            k += p["trace_steps"]
            records["segment"] = segment
        if time.monotonic() - window_start >= ctx.seconds:
            break
    _sync(ctx.device)
    steps = k - p["check_steps"]
    records["window_s"] = time.monotonic() - window_start
    records["steps"] = steps
    records["info"] = {"launches_per_step": counters.per(launches, counters.launches(), steps),
                       "last_loss": float(prog.metrics[-1]["loss"])}
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    failed = sum(float(m["grads_finite"]) < 1.0 for m in prog.metrics[p["check_steps"]:])
    numbers = judge(prog)
    return Outcome(attempted=steps, failed=int(failed), records=records,
                   checks=limited(numbers, cell.cell["limits"]), memory_peak_bytes=peak,
                   trace=None if segment is None else segment["trace"])


def _traced_segment(prog: Program, device, k: int, n: int) -> dict:
    _sync(device)
    host = []
    with Segment() as seg:
        for j in range(k, k + n):
            t0 = time.perf_counter()
            prog.step(j)
            host.append((time.perf_counter() - t0) * 1e3)
    return {"trace": seg.result, "steps": n, "step_host_ms": host}


# ---- the comparison ----------------------------------------------------------


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              names: List[str]) -> float:
    """The worst leaf's |norm(got) - norm(want)| / max(norm(want), median norm(want))."""
    g = {n: float(torch.linalg.vector_norm(got[n].double())) for n in names}
    w = {n: float(torch.linalg.vector_norm(want[n].double())) for n in names}
    med = statistics.median(w.values())
    return max(abs(g[n] - w[n]) / max(w[n], med, 1e-300) for n in names)


def follow(config: dict, p: dict, seed: int, params: dict, device, control: bool = False
           ) -> dict:
    """The reference (or, with `control`, its float8 form) through the first
    check_steps steps: losses, the first clipped gradient, the leaves after."""
    trainer = Trainer(config, params, fp8 if control else None)
    losses, first = [], None
    for k in range(p["check_steps"]):
        batch, draws = batch_of(config, p, seed, k, device)
        losses.append(trainer.loss_and_grads(batch["image"], batch["tokens"], draws))
        clipped = trainer.update()
        if k == 0:
            first = {n: g.clone() for n, g in clipped.items()}
    return {"losses": losses, "first_grad": first,
            "after": {n: v.detach() for n, v in trainer.leaves.items()}}


def compare(got: dict, want: dict, before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(want["first_grad"])
    norms = {n: float(torch.linalg.vector_norm(want["first_grad"][n].double())) for n in names}
    med = statistics.median(norms.values())
    moving = [n for n in names if norms[n] >= SMALL_LEAF * med]
    change = lambda side: {n: side["after"][n].double() - before[n].double()  # noqa: E731
                           for n in moving}
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_rel": loss,
            "grad_leaf_gap": _leaf_gap(got["first_grad"], want["first_grad"], names),
            "update_leaf_gap": _leaf_gap(change(got), change(want), moving)}


def judge(prog: Program) -> Dict[str, float]:
    p = prog.p
    got = {"losses": [float(m["loss"]) for m in prog.metrics[:p["check_steps"]]],
           "first_grad": prog.first_grad, "after": prog.after}
    exact = float(sum(float(m["grads_finite"]) < 1.0 for m in prog.metrics[:p["check_steps"]]))
    exact += float(set(got["first_grad"]) != {n for n in prog.params
                                               if n.startswith(ref.PREFIX["unet"])})
    prog.release()
    if exact:
        return {"exact_mismatches": exact, "loss_rel": float("inf"),
                "grad_leaf_gap": float("inf"), "update_leaf_gap": float("inf")}
    with ref.fp32_mode():
        want = follow(prog.config, p, prog.seed, prog.params, prog.device)
    before = {n: v for n, v in prog.params.items() if n in want["first_grad"]}
    return {"exact_mismatches": exact, **compare(got, want, before)}


def calibrate(cell, seeds: List[int], control_seeds: List[int], device) -> List[dict]:
    """Readings of sound runs (each seed: its weights, the first steps through
    the program's step) and of the float8 control in the program's place."""
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        prog = Program(cell.config, cell.traffic, seed, device)
        prog.warm()
        if seed in seeds:
            out.append({"seed": seed, "side": "program", **judge(prog)})
        else:
            prog.release()
        if seed in control_seeds:
            with ref.fp32_mode():
                want = follow(cell.config, cell.traffic, seed, prog.params, device)
                got = follow(cell.config, cell.traffic, seed, prog.params, device, control=True)
            before = {n: v for n, v in prog.params.items() if n in want["first_grad"]}
            out.append({"seed": seed, "side": "control", "exact_mismatches": 0.0,
                        **compare(got, want, before)})
        del prog
    return out
