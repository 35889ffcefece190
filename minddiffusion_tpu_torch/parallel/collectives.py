"""The collectives of a train step on the process grid: what XLA inserts
for the JAX package's sharded step (its gradient psum, the global norm,
the loss mean), written out.

  * `gradients`: the gradient of every param. One process: autograd.grad
    (zeros where the loss does not reach a param). Under dp the same, then
    the average over the data ranks by bucketed all_reduce (SUM, then / n:
    gloo has no AVG). A DistributedDataParallel wrapper would not do: its
    all-reduce runs from hooks that autograd.grad does not fire. Under
    fsdp (FSDP2-sharded networks) `loss.backward()`, whose reduce-scatter
    leaves each rank the average of its shard in `.grad` (autograd.grad
    returns None for a sharded param). Under a process group a trainable
    param with no gradient raises: it is a wiring fault, not a zero.
  * `global_norm`: the fp32 L2 norm of all the gradient's elements, a
    sharded gradient's shards summed over their ranks.
  * `mean_over_ranks`: a step's metrics averaged over the data ranks.
  * `full_state`: a state dict (nested dicts too) gathered whole, on the
    CPU, on rank 0, for a checkpoint in the one-process format. Every rank
    must call it. FSDP2's shards are gathered with all_gather_into_tensor;
    DTensor.full_tensor's functional all-gather crashes the process under
    gloo on CUDA tensors (torch 2.11, H100).
  * `global_rows`: a draw for the global batch, cut to this rank's rows,
    so a step's draws do not depend on the grid; `all_gather_rows` the
    rows of every rank joined back into the global batch.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Set

import torch

from minddiffusion_tpu_torch.parallel.mesh import Rows, mesh_shape, rank, world_size

BUCKET_ELEMS = 1 << 24      # 64 MB of fp32 an all_reduce


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def gradients(loss: torch.Tensor, params: Callable[[], Mapping[str, torch.nn.Parameter]],
              trainable: Set[str], mesh=None) -> Dict[str, torch.Tensor]:
    """name -> gradient of `loss` (averaged over the data ranks under a
    grid) for every param of `params()`. A callable: under fsdp the params
    to read are the sharded ones that FSDP2 registers again after the
    backward (between forward and backward the root's are unsharded)."""
    if mesh is not None and mesh_shape(mesh)["fsdp"] > 1:
        loss.backward()
        named = params()
        grads = []
        for p in named.values():
            grads.append(p.grad)
            p.grad = None            # backward accumulates: the next step starts empty
    else:
        named = params()
        grads = list(torch.autograd.grad(loss, list(named.values()), allow_unused=True))
    out = {}
    for (n, p), g in zip(named.items(), grads):
        if g is None:
            if mesh is not None and n in trainable:
                raise RuntimeError(f"no gradient for the trainable param {n} under a "
                                   "process group")
            g = torch.zeros_like(p)
        out[n] = g
    if mesh is not None and mesh_shape(mesh)["fsdp"] == 1 and world_size() > 1:
        all_reduce_mean(list(out.values()))
    return out


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Average `tensors` over every rank, in place: flattened into buckets
    of at most BUCKET_ELEMS elements of one dtype, one all_reduce each."""
    import torch.distributed as dist

    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(world_size())
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def _buckets(tensors: List[torch.Tensor]):
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group:
            if bucket and size + t.numel() > BUCKET_ELEMS:
                yield bucket
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel()
        if bucket:
            yield bucket


def _sq_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.float() for t in tensors]))).square()


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of every element together (optax.global_norm); a
    DTensor counts once, its shards' squares summed over the mesh dims it
    is sharded on."""
    plain = [t for t in tensors if not is_dtensor(t)]
    sharded = [t for t in tensors if is_dtensor(t)]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [t.float() for t in plain])))
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in sharded:
        dims = tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard))
        groups.setdefault((id(t.device_mesh), dims), []).append(t)
    sq = _sq_norm(plain) if plain else torch.zeros((), device=sharded[0].device)
    for (_, dims), ts in groups.items():
        part = _sq_norm([t.to_local() for t in ts])
        for d in dims:
            dist.all_reduce(part, group=ts[0].device_mesh.get_group(d))
        sq = sq + part
    return sq.sqrt()


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over every rank (one all_reduce)."""
    if world_size() == 1:
        return metrics
    import torch.distributed as dist

    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    flat.div_(world_size())
    return dict(zip(keys, flat.unbind()))


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whole on every rank of its mesh (FSDP2's Shard(0), padded
    to equal chunks, by all_gather_into_tensor), or a plain tensor as it
    is; collective for a DTensor."""
    if not is_dtensor(t):
        return t.detach()
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    local = t.to_local().detach()
    for d, p in reversed(list(enumerate(t.placements))):
        if not isinstance(p, Shard):
            continue
        if p.dim != 0:
            raise NotImplementedError(f"gather of a Shard({p.dim}) placement")
        group = t.device_mesh.get_group(d)
        n = dist.get_world_size(group)
        chunk = -(-t.shape[0] // n)
        padded = local.new_zeros((chunk,) + tuple(local.shape[1:]))
        padded[:local.shape[0]] = local
        out = local.new_empty((n * chunk,) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, padded.contiguous(), group=group)
        local = out[:t.shape[0]]
    return local


def full_state(tree: Mapping) -> Optional[Dict]:
    """`tree` (name -> tensor, or nested dicts of them) gathered whole and
    moved to the CPU on rank 0; None on the other ranks, which must call it
    all the same (the gather is collective)."""
    primary = rank() == 0
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = full_state(v)
            continue
        v = whole(v)                 # on every rank: the gather is collective
        out[k] = v.cpu() if primary else None
    return out if primary else None


def global_rows(draw, rows: Rows, shape, **kwargs) -> torch.Tensor:
    """draw((rows.count * shape[0],) + shape[1:], **kwargs) cut to this
    rank's rows: `shape` is this rank's."""
    full = draw((rows.count * shape[0],) + tuple(shape[1:]), **kwargs)
    return rows.take(full)


def all_gather_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Every rank's rows of a batch split `rows.count` ways, joined in
    rank order (each rank passes its own); `x` itself for one rank."""
    if rows.count == 1:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(rows.count)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
