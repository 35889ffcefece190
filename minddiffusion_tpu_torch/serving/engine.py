"""Micro-batching serving engine over one pipeline at a fixed batch size
(port of minddiffusion_tpu/serving/engine.py, with the same contract).

  * requests arrive on any thread via `submit()` (blocking) and a
    background worker groups them into batches of the pipeline's size; a
    partial batch is padded by repeating its last row;
  * per-request work (validation, tokenization, host-side noise) runs in
    `adapter.prepare()` on the caller's thread: a bad request fails only its
    own caller, and tokenization overlaps the previous batch's device time;
  * per-request determinism: every random input of a request derives from
    its own seed, so the same (prompt, negative_prompt, seed) returns the
    same image whatever it is batched with. For SD that is x_T, drawn on the
    host from Philox(seed) exactly as the JAX engine draws it and handed to
    the pipeline's `noise=`; for GLIDE the cascade's `row_seeds`;
  * a caller that times out marks its request abandoned, and the worker
    drops abandoned requests instead of spending batch rows on them.

Adapters (SDAdapter / GlideAdapter) carry the per-family logic:
`prepare(prompt, negative_prompt, seed) -> payload` and the split pair
`dispatch(payloads) -> handle` / `fetch(handle) -> (batch, H, W, 3) uint8`
(the engine also takes an adapter with a blocking `run(payloads)` instead).
With the split pair the worker keeps one batch in flight: it dispatches
batch N+1 before it fetches batch N. On the card `dispatch` copies the batch to the device
from pinned memory, enqueues the pipeline, enqueues the copy of the uint8
result into pinned host memory and records a CUDA event, all without
waiting on the device; `fetch` waits on the event. The device then works
through the host's stack / enqueue / transfer time between batches. The
engine adds no math. The worker runs under `torch.inference_mode()` on the
adapter's CUDA device (both are per thread). See cli/serve.py for the HTTP
front end.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

_MAX_SEED = 2**63 - 1  # Philox takes any non-negative Python int; cap sanely


class BatchExecutionError(RuntimeError):
    """A worker-side batch failure: a server fault, never the caller's input.

    submit() wraps worker exceptions in this type so that HTTP front ends
    map client-input errors (adapter.prepare raising on the caller thread,
    e.g. ValueError for a bad seed) to 400 and batch failures to 500 without
    guessing from the class of the exception the worker happened to raise."""


@dataclass
class Request:
    payload: dict
    done: threading.Event = field(default_factory=threading.Event)
    image: Optional[np.ndarray] = None   # (H, W, 3) uint8
    error: Optional[BaseException] = None
    abandoned: bool = False


def _to_device(arrays: list, device: torch.device) -> list:
    """numpy arrays -> tensors on `device`; to a CUDA device through pinned
    memory with non_blocking copies (a pageable copy would synchronise)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


def _start_fetch(images: torch.Tensor):
    """Start the device-to-host copy of `images` (uint8); fetch with
    `_finish_fetch`. On the CPU the tensor is already on the host."""
    if images.device.type != "cuda":
        return images, None
    host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
    host.copy_(images, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(handle) -> np.ndarray:
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


class SDAdapter:
    """StableDiffusionPipeline.build_txt2img programs
    (`fn(models, tokens, uncond, generator, noise) -> uint8 images`)."""

    def __init__(self, fn: Callable, models, tokenize: Callable[[str], np.ndarray],
                 latent_hw: tuple):
        self._fn = fn
        self._models = models
        self._tokenize = tokenize
        self._latent_hw = latent_hw
        # where the JAX adapter holds PRNGKey(0): the DDIM, PLMS and DPM
        # multistep samplers draw nothing beyond `noise`
        self._generator = torch.Generator(device=models.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self._models.device

    def prepare(self, prompt: str, negative_prompt: str, seed: int) -> dict:
        seed = int(seed)
        if not 0 <= seed <= _MAX_SEED:
            raise ValueError(f"seed must be in [0, 2**63), got {seed}")
        h8, w8 = self._latent_hw
        # host-side counter-based RNG, the JAX engine's bits
        noise = (np.random.Generator(np.random.Philox(seed))
                 .standard_normal((h8, w8, 4), np.float32))
        return {
            "tokens": np.asarray(self._tokenize(str(prompt)), np.int32),
            "uncond": np.asarray(self._tokenize(str(negative_prompt)), np.int32),
            "noise": noise,
        }

    def dispatch(self, payloads: list):
        """Enqueue the batch on the device; returns the fetch handle."""
        tokens, uncond, noise = _to_device(
            [np.stack([p[k] for p in payloads]) for k in ("tokens", "uncond", "noise")],
            self.device)
        return _start_fetch(self._fn(self._models, tokens, uncond, self._generator,
                                     noise=noise))

    def fetch(self, handle) -> np.ndarray:
        """Wait for the batch and return its uint8 images on the host."""
        return _finish_fetch(handle)


class GlideAdapter:
    """GlideCascadePipeline.build_generate programs
    (`fn(models, tokens, mask, generator, row_seeds=) -> {stage: uint8}`).

    `tokenize(prompt) -> (tokens, mask)` (padded_tokens_and_mask). GLIDE has
    no negative-prompt input (its uncond is random tokens); a request's
    negative_prompt is ignored, and IGNORED_PARAMS lets front ends report
    the drop to the client. `stage` picks the cascade output to serve.
    """

    IGNORED_PARAMS = ("negative_prompt",)

    def __init__(self, fn: Callable, models, tokenize: Callable[[str], tuple],
                 stage: str = "srgan"):
        self._fn = fn
        self._models = models
        self._tokenize = tokenize
        self._stage = stage
        # where the JAX adapter holds PRNGKey(0): row_seeds fixes every draw
        self._generator = torch.Generator(device=models.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self._models.device

    def prepare(self, prompt: str, negative_prompt: str, seed: int) -> dict:
        seed = int(seed)
        if not 0 <= seed < 2**31:  # the JAX row_seeds input is int32
            raise ValueError(f"seed must be in [0, 2**31), got {seed}")
        tokens, mask = self._tokenize(str(prompt))
        return {
            "tokens": np.asarray(tokens, np.int64),
            "mask": np.asarray(mask, np.int64),
            "seed": seed,
        }

    def dispatch(self, payloads: list):
        tokens, mask = _to_device(
            [np.stack([p[k] for p in payloads]) for k in ("tokens", "mask")], self.device)
        out = self._fn(self._models, tokens, mask, self._generator,
                       row_seeds=[p["seed"] for p in payloads])
        return _start_fetch(out[self._stage])

    def fetch(self, handle) -> np.ndarray:
        return _finish_fetch(handle)


class BatchingEngine:
    """Batches concurrent requests onto one pipeline through an adapter
    (SDAdapter / GlideAdapter). batch_size must match the batch the pipeline
    was built for. `max_wait_ms` bounds how long the worker holds the first
    request of a batch while waiting for more traffic."""

    def __init__(self, adapter, *, batch_size: int, max_wait_ms: float = 25.0):
        self._adapter = adapter
        self._batch = batch_size
        self._max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        # stats
        self.batches_run = 0
        self.requests_served = 0
        self._abandoned_pending = 0   # timed-out requests still in the queue
        self._abandoned_lock = threading.Lock()

    @property
    def adapter(self):
        return self._adapter

    @property
    def queue_depth(self) -> int:
        """Live backlog: queued requests someone still waits on. Abandoned
        (timed-out) entries stay in the queue until the worker drains them
        but are no future work, so they are not counted."""
        return max(0, self._q.qsize() - self._abandoned_pending)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        if self._started:
            self._worker.join(timeout=join_timeout)

    # -- client API --------------------------------------------------------

    def submit(self, prompt: str, negative_prompt: str = "", seed: int = 0,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocks until the image is ready; thread-safe. Same (prompt,
        negative_prompt, seed) -> bitwise the same image, whatever the
        batching. Validation and tokenizer errors raise here without
        touching other requests."""
        req = Request(payload=self._adapter.prepare(prompt, negative_prompt, seed))
        self._q.put(req)
        if not req.done.wait(timeout):
            # mark abandoned under the lock, so the worker either drops it
            # from the queue or sees the flag at finish time: the pending
            # counter is decremented in exactly one of those places
            with self._abandoned_lock:
                if not req.done.is_set():
                    req.abandoned = True
                    self._abandoned_pending += 1
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise BatchExecutionError(f"batch execution failed: {req.error!r}") from req.error
        return req.image

    # -- worker ------------------------------------------------------------

    def _collect(self, idle_timeout: float = 0.1) -> list:
        batch = []
        deadline = None
        while len(batch) < self._batch:
            if deadline is None:
                timeout = idle_timeout
            else:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    return batch
            try:
                req = self._q.get(timeout=timeout)
            except queue.Empty:
                return batch
            if req.abandoned:
                with self._abandoned_lock:
                    self._abandoned_pending = max(0, self._abandoned_pending - 1)
                    req.abandoned = False  # counted exactly once
                continue  # the caller timed out while queued: shed the dead work
            batch.append(req)
            if deadline is None:
                deadline = time.monotonic() + self._max_wait
        return batch

    def _fail(self, batch: list, e: BaseException) -> None:
        for r in batch:
            r.error = e
            self._finish(r)

    def _deliver(self, batch: list, imgs: np.ndarray) -> None:
        for i, r in enumerate(batch):
            r.image = imgs[i]
            self._finish(r)
        self.batches_run += 1
        self.requests_served += len(batch)

    def _fetch_into(self, pending: tuple) -> None:
        batch, handle = pending
        try:
            self._deliver(batch, self._adapter.fetch(handle))
        except BaseException as e:  # noqa: BLE001 -- a device fault belongs to this batch
            self._fail(batch, e)

    def _device_scope(self):
        """inference_mode and the adapter's CUDA device, both per thread."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        device = getattr(self._adapter, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            stack.enter_context(torch.cuda.device(device))
        return stack

    def _run(self) -> None:
        # A split (dispatch / fetch) adapter keeps one batch in flight:
        # batch N+1 is dispatched before batch N is fetched. A run() adapter
        # takes the blocking path.
        pipelined = hasattr(self._adapter, "dispatch") and hasattr(self._adapter, "fetch")
        pending: Optional[tuple] = None  # (batch, fetch handle)
        with self._device_scope():
            while not self._stop.is_set():
                # with a batch in flight, poll briefly before fetching it
                batch = self._collect(idle_timeout=0.005 if pending else 0.1)
                handle = None
                if batch:
                    rows = [r.payload for r in batch]
                    rows += [rows[-1]] * (self._batch - len(batch))  # repeat-pad
                    try:
                        if pipelined:
                            handle = self._adapter.dispatch(rows)
                        else:
                            self._deliver(batch, self._adapter.run(rows))
                            batch = []
                    except BaseException as e:  # noqa: BLE001 -- fail its callers
                        self._fail(batch, e)
                        batch = []
                if pending is not None:
                    self._fetch_into(pending)
                    pending = None
                if batch:
                    pending = (batch, handle)
            if pending is not None:  # drain the batch in flight on stop()
                self._fetch_into(pending)

    def _finish(self, req: Request) -> None:
        """Set done under the abandonment lock: a caller that raced its
        timeout against this finish is reconciled in the pending counter."""
        with self._abandoned_lock:
            if req.abandoned:
                self._abandoned_pending = max(0, self._abandoned_pending - 1)
            req.done.set()
