"""Training loop: epochs x steps with callbacks, checkpoints and profiling
(port of minddiffusion_tpu/train/loop.py).

The JAX loop fetches every step's metrics to the host (`device_get`), which
blocks the host on the device each step. This loop keeps each step's
metrics on the device and fetches all pending ones in one transfer at its
boundaries: every `fetch_every` steps, before a checkpoint, at `max_steps`
and at an epoch's end. Then it replays `on_step_end(step, metrics)` for
each pending step in order, so `LossMonitor` logs the same means at the
same steps as the JAX loop. `step_time_s` is the host time between two
step dispatches: over a window it sums to the window's wall time, because
the host waits for the device at every fetch.

On a process grid the checkpoint is gathered whole first
(parallel/collectives.full_state: every rank joins, rank 0 writes; tp
pieces joined back), so its file is the one-process format that every
loader of the port reads.

`ProfilerCallback` records a `torch.profiler` trace (CPU and CUDA
activities) of steps (start_step, stop_step] and writes its Chrome trace
and its per-op table into `log_dir` (on a grid, each rank its own files,
named with its rank).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
from minddiffusion_tpu_torch.parallel.collectives import full_state
from minddiffusion_tpu_torch.parallel.mesh import rank, world_size
from minddiffusion_tpu_torch.utils.logger import KVLogger, get_logger


class Callback:
    def on_step_dispatched(self, step: int) -> None:
        """Right after step `step` was queued (host side, no metrics)."""

    def on_step_end(self, step: int, metrics: Dict[str, float]) -> None:
        """Step `step`'s metrics as host floats (replayed at a fetch)."""

    def on_epoch_end(self, epoch: int) -> None: ...


class LossMonitor(Callback):
    def __init__(self, logger: Optional[KVLogger] = None, log_every: int = 10):
        self.logger = logger or get_logger()
        self.log_every = log_every

    def on_step_end(self, step: int, metrics: Dict[str, float]) -> None:
        self.logger.logkv_mean("loss", metrics["loss"])
        self.logger.logkv_mean("step_time_s", metrics["step_time_s"])
        if "grads_finite" in metrics and metrics["grads_finite"] != 1.0:
            self.logger.logkv("nonfinite_grad_step", step)
        if step % self.log_every == 0:
            self.logger.logkv("step", step)
            self.logger.dumpkvs()


class ProfilerCallback(Callback):
    """A torch.profiler trace over steps (start_step, stop_step]."""

    def __init__(self, log_dir: str, start_step: int, stop_step: int):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self._prof = None

    def on_step_dispatched(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        if step + 1 == self.start_step and self._prof is None:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif step + 1 == self.stop_step and self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            tag = f"_rank{rank()}" if world_size() > 1 else ""    # one file a rank
            self._prof.export_chrome_trace(os.path.join(self.log_dir, f"trace{tag}.json"))
            sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
            with open(os.path.join(self.log_dir, f"profile_ops{tag}.txt"), "w") as f:
                f.write(self._prof.key_averages().table(sort_by=sort, row_limit=60))
            self._prof = None


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    """step_fn(state, batch, seed) -> metrics (device tensors); dataset
    exposes .epoch(i) iterators of numpy batch dicts."""

    step_fn: Callable
    dataset: object
    seed: int
    device: torch.device
    callbacks: List[Callback] = dataclasses.field(default_factory=list)
    ckpt_manager: Optional[CheckpointManager] = None
    max_steps: Optional[int] = None
    # state dict -> the dict the ckpt_manager saves (LoRA: the adapters only)
    ckpt_transform: Optional[Callable] = None
    fetch_every: int = 10

    def _flush(self, pending: List) -> None:
        if not pending:
            return
        keys = sorted(pending[0][1])
        values = torch.stack([torch.stack([m[k].float() for k in keys])
                              for _, m, _ in pending]).cpu().tolist()
        for (step, _, dt), row in zip(pending, values):
            metrics = dict(zip(keys, row), step_time_s=dt)
            for cb in self.callbacks:
                cb.on_step_end(step, metrics)
        pending.clear()

    def fit(self, state, epochs: int = 1):
        pending: List = []
        t_prev = time.time()
        for epoch in range(epochs):
            for batch in self.dataset.epoch(epoch):
                metrics = self.step_fn(state, to_device(batch, self.device), self.seed)
                step, now = state.step, time.time()
                pending.append((step, metrics, now - t_prev))
                t_prev = now
                for cb in self.callbacks:
                    cb.on_step_dispatched(step)
                save = self.ckpt_manager is not None and self.ckpt_manager.should_save(step)
                last = self.max_steps is not None and step >= self.max_steps
                if save or last or step % self.fetch_every == 0:
                    self._flush(pending)
                if save:
                    sd = state.models.state_dict()
                    tree = self.ckpt_transform(sd) if self.ckpt_transform else sd
                    self.ckpt_manager.save(step, tree if getattr(state, "mesh", None) is None
                                           else full_state(tree, getattr(state, "tp", None)))
                if last:
                    return state
            self._flush(pending)
            for cb in self.callbacks:
                cb.on_epoch_end(epoch)
        return state
