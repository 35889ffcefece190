"""Training checkpoints as torch state dicts (port of
minddiffusion_tpu/io/checkpoints.py, which saves with orbax).

What is saved is what the JAX loop saves: the params only, not the
optimizer state (JAX train/loop.py:96-99; the GLIDE CLI saves {"params",
"ema"}, two state dicts), and in LoRA mode the adapters only
(`trainable_only` with the LoRA set, the MindPet
TrainableParamsCheckPoint equivalent). A checkpoint is one file
`<directory>/ckpt_<step:08d>.pt` holding a flat LDM-named state dict, moved
to the CPU. `CheckpointManager` keeps orbax's save decision: the first
`should_save` of a directory with no checkpoint is true (orbax's initial
save), later ones at multiples of `save_every_steps`, never at or below the
latest saved step; it keeps the newest `keep_max` files.

Under a process group only rank 0 writes (the JAX package's `_is_primary`),
and every rank takes the same save decision: the latest saved step is read
from rank 0's directory once, when the manager is made (a broadcast, so
every rank must make it), and then advanced by `save` on every rank. A
decision that each rank read from its own disk could differ between ranks,
and a save under fsdp is a gather that every rank must join.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional

import torch

from minddiffusion_tpu_torch.parallel.mesh import rank, world_size

_NAME = re.compile(r"^ckpt_(\d{8,})\.pt$")


def _to_cpu(tree: Dict) -> Dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write `state_dict` (moved to the CPU; nested dicts of tensors too, as
    GLIDE's {"params", "ema"}) to `path` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state_dict), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, save_every_steps: int = 10_000, keep_max: int = 10):
        self.directory = os.path.abspath(directory)
        self.save_every_steps = save_every_steps
        self.keep_max = keep_max
        self._latest = self.latest_step() if rank() == 0 else None
        if world_size() > 1:
            import torch.distributed as dist

            box = [self._latest]
            dist.broadcast_object_list(box, src=0)
            self._latest = box[0]

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def should_save(self, step: int) -> bool:
        if self._latest is None:
            return True
        return step > self._latest and step % self.save_every_steps == 0

    def save(self, step: int, state_dict: Optional[Dict[str, torch.Tensor]]) -> None:
        """Write `state_dict` on rank 0 (the other ranks pass what they
        hold, None after a gather) and drop the oldest files."""
        self._latest = step
        if rank() != 0:
            return
        save_checkpoint(self.path(step), state_dict)
        for old in self.steps()[:-self.keep_max]:
            os.unlink(self.path(old))

    def restore_latest(self) -> Optional[Dict[str, torch.Tensor]]:
        step = self.latest_step()
        return None if step is None else load_checkpoint(self.path(step))


def trainable_only(state_dict: Dict[str, torch.Tensor],
                   names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The entries of `names` only: a LoRA-style small checkpoint."""
    keep = set(names)
    return {k: v for k, v in state_dict.items() if k in keep}


def merge_params(base: Dict[str, torch.Tensor],
                 partial: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A partial (trainable-only) checkpoint over full base params; raises
    on a partial entry the base lacks."""
    unknown = sorted(set(partial) - set(base))
    if unknown:
        raise KeyError(f"checkpoint entries the base lacks: {unknown[:5]}")
    return {**base, **partial}
