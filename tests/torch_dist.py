"""Multi-process runs of the port on the CPU for tests/test_torch_parallel.py.

`start_ranks(jobs, world, tmp_path).join()` starts `world` spawned
processes, each in a gloo process group that meets through a FileStore in
`tmp_path` (no TCP port: several pytest workers share the machine), on one
intra-op thread, runs each job `(fn, args)` in turn on every rank, and
returns each rank's results. One session carries every job, so the
processes start once, and the caller can work while they run. A rank that
raises fails `join` with its traceback; ranks still running at the
deadline are killed and `join` fails, so no test hangs.

The workers below run on the port alone (no JAX import in a child) and
take plain data: configs as keyword dicts, weights and batches as files
that the parent wrote with torch.save.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback

import torch


def _child(jobs, rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        result = ("ok", [fn(*args) for fn, args in jobs])
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


class Session:
    """`world` spawned ranks running `jobs` (start_ranks); `join` waits for
    them, up to `timeout` seconds from the start."""

    def __init__(self, jobs, world: int, tmp_path, timeout: float):
        ctx = multiprocessing.get_context("spawn")
        store = os.path.join(str(tmp_path), f"store_{time.time_ns()}")
        self.outs = [f"{store}.rank{r}" for r in range(world)]
        self.procs = [ctx.Process(target=_child, args=(jobs, r, world, store, self.outs[r]))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.time() + timeout
        self.timeout = timeout

    def join(self) -> list:
        """-> one list a rank of each job's result."""
        for p in self.procs:
            p.join(max(self.deadline - time.time(), 0.1))
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive:
            raise TimeoutError(f"ranks {alive} still running after {self.timeout} s")
        results = []
        for r, path in enumerate(self.outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {self.procs[r].exitcode} "
                                   "and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results


def start_ranks(jobs, world: int, tmp_path, timeout: float = 240.0) -> Session:
    """Start each (fn, args) of `jobs`, in turn, on `world` ranks; the
    caller works on while they run and then calls `.join()`."""
    return Session(jobs, world, tmp_path, timeout)


def _sd_models(cfg: dict, weights: str):
    from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
    from minddiffusion_tpu_torch.models.unet import UNetConfig
    from minddiffusion_tpu_torch.models.vae import VAEConfig
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    device = cfg.get("device", "cpu")
    if device != "cpu":
        torch.cuda.set_device(device)
    models = SDModels.create(
        family=cfg["family"], dtype=cfg.get("dtype", torch.float32), device=device,
        param_dtype=cfg.get("param_dtype"), unet_config=UNetConfig(**cfg["unet"]),
        vae_config=VAEConfig(**cfg["vae"]), text_config=CLIPTextConfig(**cfg["text"]))
    models.load_state_dict(torch.load(weights, weights_only=True))
    return models


class OneBatch:
    """A dataset of one epoch of one batch (numpy dict)."""

    def __init__(self, batch: dict):
        self.batch = batch

    def epoch(self, epoch_index: int = 0):
        yield self.batch


def replicated() -> list:
    """parallel.replicate on a rank-dependent tensor: every rank's copy
    after it."""
    from minddiffusion_tpu_torch.parallel import replicate
    from minddiffusion_tpu_torch.parallel.mesh import rank

    return replicate({"x": torch.full((3,), float(rank()))})["x"].tolist()


def _tp_grads(grads: dict, tp) -> dict:
    """The gradients of the params whole on every tp rank (no tp piece)."""
    return {n: g.detach().clone() for n, g in grads.items() if n not in tp.pieces}


def sd_train(cfg: dict, weights: str, data: str, grid, ckpt_dir: str) -> dict:
    """SD train steps through `Trainer` (the batch in `data` each step, with
    that step's global draws) on the grid `grid` ((dp, fsdp[, tp]); None:
    one process, no group), on this rank's rows; a checkpoint every step,
    gathered whole and written by rank 0, is read back. -> {"metrics"
    (a list, one a step), "ckpt" (rank 0; None elsewhere), "saved",
    "resolved"}: one process also marks each gradient's resolved elements,
    those 0 or above 1e-3 of their tensor's largest in every step. Under tp
    (fsdp 1) also "shapes" (each param's shape on this rank) and "grads",
    the first step's gradients of the params whole on every tp rank."""
    from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
    from minddiffusion_tpu_torch.parallel import MeshConfig, make_mesh, shard_batch
    from minddiffusion_tpu_torch.parallel.mesh import rank
    from minddiffusion_tpu_torch.train.loop import Callback, Trainer
    from minddiffusion_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                       make_loss_and_grads, make_train_step)

    models = _sd_models(cfg, weights)
    device = models.device
    blob = torch.load(data, weights_only=True, map_location=device)
    mesh = None if grid is None else make_mesh(MeshConfig(*grid), device.type)
    config = TrainConfig(**cfg["train"])
    state = create_train_state(models, config, mesh=mesh)
    step = make_train_step(config)
    batch = blob["batch"] if mesh is None else shard_batch(blob["batch"], mesh)
    class Record(Callback):
        def __init__(self):
            self.steps = []

        def on_step_end(self, step, metrics):
            self.steps.append(dict(metrics))

    record = Record()
    manager = CheckpointManager(ckpt_dir, save_every_steps=1)
    steps = len(blob["draws"])
    resolved = {}
    loss_and_grads = make_loss_and_grads(config)
    extra = {}
    if state.tp is not None and grid[1] == 1:
        extra["shapes"] = {n: tuple(p.shape) for n, p in state.grad_params.items()}
        extra["grads"] = _tp_grads(loss_and_grads(state, batch, None, blob["draws"][0])[1],
                                   state.tp)

    def step_fn(s, b, seed):
        draws = blob["draws"][s.step]
        if mesh is None:        # which gradient elements are resolved in every step
            for n, g in loss_and_grads(s, b, None, draws)[1].items():
                big = (g.abs() > 1e-3 * g.abs().max()) | (g == 0)
                resolved[n] = big & resolved.get(n, big)
        return step(s, b, seed, draws=draws)

    Trainer(step_fn, OneBatch({k: v.cpu().numpy() for k, v in batch.items()}), seed=0,
            device=device, callbacks=[record], ckpt_manager=manager,
            max_steps=steps).fit(state, epochs=steps)
    ckpt = manager.restore_latest() if rank() == 0 else None
    return {"metrics": record.steps, "ckpt": ckpt, "saved": manager.steps(),
            "resolved": resolved, **extra}


def glide_train(cfg: dict, weights: str, data: str, grid) -> dict:
    """One GLIDE step (cli/glide_train.build_step) on the grid `grid` (None:
    one process, which also returns the step's gradient) with the global
    noise in `data`. -> {"metrics", "params", "ema"[, "grads"]}, gathered
    whole on rank 0; under tp every rank's "grads" are the gradients of
    the params whole on every tp rank."""
    from minddiffusion_tpu_torch.cli import glide_train as gt
    from minddiffusion_tpu_torch.models.glide import GlideUNetConfig, XfConfig
    from minddiffusion_tpu_torch.parallel import MeshConfig, batch_sharding, make_mesh, shard_batch
    from minddiffusion_tpu_torch.parallel.collectives import full_state

    model = gt.build_model(cfg["super_res"], GlideUNetConfig(**cfg["unet"]),
                           XfConfig(**cfg["xf"]), torch.device("cpu"), torch.float32, 0)
    model.load_state_dict(torch.load(weights, weights_only=True))
    blob = torch.load(data, weights_only=True)
    mesh = None if grid is None else make_mesh(MeshConfig(*grid), "cpu")
    state = gt.create_train_state(model, cfg["lr"], 0, 10, mesh=mesh)
    schedule = gt.glide_schedule(cfg["super_res"])
    step = gt.build_step(schedule, cfg["super_res"], 0.9)
    batch = blob["batch"] if mesh is None else shard_batch(blob["batch"], mesh)
    extra = {}
    if mesh is None or state.tp is not None:
        noise = blob["noise"] if mesh is None else batch_sharding(mesh).take(blob["noise"])
        grads = gt.loss_and_grads(state, schedule, cfg["super_res"], batch, noise)[1]
        extra["grads"] = grads if mesh is None else _tp_grads(grads, state.tp)
    metrics = {k: v.item() for k, v in step(state, batch, 0, noise=blob["noise"]).items()}
    tree = {"params": state.models.state_dict(), "ema": state.ema}
    return {"metrics": metrics, **(full_state(tree, state.tp) or {}), **extra}


def run_cli(module: str, argv: list, assets: str = None):
    """`main(argv)` of a CLI module of the port on every rank; -> the steps
    taken, the params gathered whole (rank 0; None elsewhere) and this
    rank's own copy where it holds them whole (under dp; None under fsdp)."""
    import importlib

    from minddiffusion_tpu_torch.parallel.collectives import full_state, is_dtensor

    if assets:
        os.environ["MINDDIFFUSION_TPU_ASSETS"] = assets
    state = importlib.import_module(module).main(argv)
    params = state.models.state_dict()
    own = None if any(is_dtensor(v) for v in params.values()) else \
        {k: v.detach().clone() for k, v in params.items()}
    return state.step, full_state(params, state.tp), own


def adaptive(x_T, w, b, c, grid, **kw) -> tuple:
    """dpm_solver.sample_adaptive over the SD schedule with the row-wise eps
    tanh(x * w + b * sin(0.003 t + c)) (tests/test_torch_dpm.py's), on this
    rank's rows of `x_T` (numpy) split over the data ranks of the grid
    `grid` (None: one process, the whole batch, no group): -> (the rows
    sampled, the model calls made)."""
    import torch.distributed as dist

    from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
    from minddiffusion_tpu_torch.parallel import MeshConfig, batch_sharding, make_mesh
    from minddiffusion_tpu_torch.samplers import dpm_solver

    w, b, c = (torch.from_numpy(a) for a in (w, b, c))
    calls = []

    def eps(x, t):
        calls.append(1)
        return torch.tanh(x * w + b * torch.sin(t.float()[0] * 0.003 + c))

    x, group = torch.from_numpy(x_T), None
    if grid is not None:
        rows = batch_sharding(make_mesh(MeshConfig(*grid), "cpu"))
        x = rows.take(x)
        group = dist.group.WORLD if rows.group is None else rows.group
    out = dpm_solver.sample_adaptive(eps, x, DiffusionSchedule.create(1000, 0.00085, 0.0120),
                                     group=group, **kw)
    return out, len(calls)


def txt2img(cfg: dict, weights: str, data: str, grid) -> torch.Tensor:
    """StableDiffusionPipeline.build_txt2img(mesh=) over the grid (None: one
    process) on the request batch and explicit x_T in `data`; with
    `cfg["count_calls"]` -> (the images, the UNet calls this rank made)."""
    from minddiffusion_tpu_torch.parallel import MeshConfig, make_mesh
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    models = _sd_models(cfg, weights)
    blob = torch.load(data, weights_only=True)
    mesh = None if grid is None else make_mesh(MeshConfig(*grid), models.device.type)
    fn = StableDiffusionPipeline(models).build_txt2img(mesh=mesh, **cfg["txt2img"])
    calls = []
    hook = models.unet.register_forward_pre_hook(lambda m, args: calls.append(1))
    images = fn(models, blob["tokens"], blob["uncond"], None, noise=blob["noise"]).cpu()
    hook.remove()
    return (images, len(calls)) if cfg.get("count_calls") else images


def txt2img_rows(cfg: dict, weights: str, data: str):
    """`txt2img`'s one-process call with every network run a row at a time
    (CLIP on the row's [uncond; cond], the guided UNet at CFG batch 2, the
    VAE decode at batch 1, the shapes a dp rank of one row runs) and the
    sampler once on the whole batch (for dpm_adaptive, the step control of
    both rows): -> (the images, the sampler's model evaluations). On the
    card a row's result depends on its place in a batch, so a rank's bytes
    are held against this there."""
    from minddiffusion_tpu_torch.core import cfg as cfg_lib, latents
    from minddiffusion_tpu_torch.pipelines import stable_diffusion as sd

    models = _sd_models(cfg, weights)
    dev = models.device
    blob = torch.load(data, weights_only=True)
    tokens, uncond = blob["tokens"].to(dev), blob["uncond"].to(dev)
    run = cfg["txt2img"]
    evals = []
    with torch.inference_mode():
        rows = [sd._guided_unet(models.unet, models.text_encoder(
            cfg_lib.fold(uncond[i:i + 1], tokens[i:i + 1])), run["guidance_scale"])
            for i in range(tokens.shape[0])]

        def eps_fn(x, t):
            evals.append(1)
            return torch.cat([f(x[i:i + 1], t) for i, f in enumerate(rows)])

        with models.unet.hoisted():
            z = sd._run_sampler(run["sampler"], eps_fn, blob["noise"].float().to(dev),
                                models.schedule, run.get("num_steps", 50), None)
        images = torch.cat([latents.unit_range_to_uint8(models.vae.decode(
            latents.unscale_latents(z[i:i + 1], models.scale_factor)))
            for i in range(z.shape[0])])
    return images.cpu(), len(evals)


def tp_attention(sites, grid, device: str = "cuda:0") -> dict:
    """SD CrossAttention self-attention in bf16 on `device`, one module a
    site (C, heads, N) of `sites` (64 channels a head, batch 2, seeded
    weights and inputs), on the grid `grid` (None: one process): -> {site:
    the output, x's gradient, every param's gradient (tp pieces joined),
    K1's launches by (B, N, heads)}."""
    from minddiffusion_tpu_torch.models.attention import CrossAttention
    from minddiffusion_tpu_torch.ops import flash_attention as fa
    from minddiffusion_tpu_torch.parallel import MeshConfig, make_mesh
    from minddiffusion_tpu_torch.parallel.collectives import whole
    from minddiffusion_tpu_torch.parallel.mesh import shard_params

    if device != "cpu":
        torch.cuda.set_device(device)
    mesh = None if grid is None else make_mesh(MeshConfig(*grid), torch.device(device).type)
    kernel = fa.flash_attention_packed
    out = {}
    for c, heads, n in sites:
        g = torch.Generator().manual_seed(c + heads)
        module = CrossAttention(c, heads, c // heads)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * c ** -0.5)
        module.to(device)
        x = torch.randn(2, n, c, generator=g).to(device, torch.bfloat16).requires_grad_()
        w = torch.randn(2, n, c, generator=g).to(device)
        tp = None if mesh is None else shard_params({"attn": module}, mesh, {"attn": ""})
        hist = {}

        def recording(q, k, v, h, *a, **kw):
            hist[(q.shape[0], q.shape[1], h)] = hist.get((q.shape[0], q.shape[1], h), 0) + 1
            return kernel(q, k, v, h, *a, **kw)

        recording.launches = kernel.launches     # the wrapper counts under its module name
        fa.flash_attention_packed = recording
        try:
            y = module(x)
            (y.float() * w).sum().backward()
        finally:
            fa.flash_attention_packed = kernel
            kernel.launches = recording.launches
        out[(c, heads, n)] = dict(
            y=y.detach().float().cpu(), dx=x.grad.float().cpu(), k1=hist,
            grads={name: whole(p.grad, name, tp).float().cpu()
                   for name, p in module.named_parameters()})
    return out
