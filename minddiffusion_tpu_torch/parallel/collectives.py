"""The collectives of a train step on the process grid: what XLA inserts
for the JAX package's sharded step (its gradient psum, the global norm,
the loss mean), written out.

  * `gradients`: the gradient of every param. One process: autograd.grad
    (zeros where the loss does not reach a param). Under dp the same, then
    the average over the data ranks (the data group: the dp x fsdp ranks of
    this rank's tp coordinate, `mesh.data_group`) by bucketed all_reduce
    (SUM, then / n: gloo has no AVG). A DistributedDataParallel wrapper would not do: its
    all-reduce runs from hooks that autograd.grad does not fire. Under
    fsdp (FSDP2-sharded networks) `loss.backward()`, whose reduce-scatter
    leaves each rank the average of its shard in `.grad` (autograd.grad
    returns None for a sharded param). Under a process group a trainable
    param with no gradient raises: it is a wiring fault, not a zero.
  * `global_norm`: the fp32 L2 norm of all the gradient's elements, a
    sharded gradient's shards summed over their ranks (a tp piece's over
    the tp ranks too; a param whole on every tp rank counts once).
  * `mean_over_ranks`: a step's metrics averaged over the data ranks.
  * `full_state`: a state dict (nested dicts too) gathered whole, on the
    CPU, on rank 0, for a checkpoint in the one-process format. Every rank
    must call it. FSDP2's shards are gathered with all_gather_into_tensor,
    then a tp piece's pieces joined (mesh.tp_unshard);
    DTensor.full_tensor's functional all-gather crashes the process under
    gloo on CUDA tensors (torch 2.11, H100).
  * The tp conjugate pairs (autograd Functions over the tp group):
    `TPCopy` identity forward / all-reduce backward (where a tensor whole
    on every tp rank enters a rank's own compute), `TPReduce` all-reduce
    forward / identity backward (a row-parallel product's partial sums),
    `TPGather` all-gather forward / own block backward (split channels
    joined for a compute every tp rank repeats). Every reduction runs in
    fp32.
  * `global_rows`: a draw for the global batch, cut to this rank's rows,
    so a step's draws do not depend on the grid; `all_gather_rows` the
    rows of every rank joined back into the global batch.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set

import torch

from minddiffusion_tpu_torch.parallel.mesh import Rows, data_group, mesh_shape, rank, tp_unshard

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
    if mesh is not None and mesh_shape(mesh)["fsdp"] == 1:
        all_reduce_mean(list(out.values()), data_group(mesh))
    return out


def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_mean(tensors: List[torch.Tensor], group=None) -> None:
    """Average `tensors` over the ranks of `group` (None: every rank), in
    place: flattened into buckets of at most BUCKET_ELEMS elements of one
    dtype, one all_reduce each."""
    import torch.distributed as dist

    n = _group_size(group)
    if n == 1:
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
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


def global_norm(tensors: List[torch.Tensor], tp=None, names: Sequence[str] = ()
                ) -> torch.Tensor:
    """The fp32 L2 norm of every element together (optax.global_norm); a
    DTensor counts once, its shards' squares summed over the mesh dims it
    is sharded on. `tp` (parallel/tensor_parallel.TensorParallel) with the
    tensors' `names`: a tp piece's squares are summed over the tp ranks
    too, a tensor whole on every tp rank counts once."""
    pieces = [tp is not None and n in tp.pieces for n in names] or [False] * len(tensors)
    if not any(pieces) and not any(is_dtensor(t) for t in tensors):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [t.float() for t in tensors])))
    import torch.distributed as dist

    sq = _sq_norm_sharded([t for t, p in zip(tensors, pieces) if not p])
    if any(pieces):
        part = _sq_norm_sharded([t for t, p in zip(tensors, pieces) if p])
        dist.all_reduce(part, group=tp.group)
        sq = part if sq is None else sq + part
    return sq.sqrt()


def _sq_norm_sharded(tensors: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """The summed squares of `tensors`, a DTensor's over its shards' ranks;
    None for no tensor."""
    if not tensors:
        return None
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    plain = [t for t in tensors if not is_dtensor(t)]
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        if is_dtensor(t):
            dims = tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard))
            groups.setdefault((id(t.device_mesh), dims), []).append(t)
    sq = _sq_norm(plain) if plain else torch.zeros((), device=tensors[0].device)
    for (_, dims), ts in groups.items():
        part = _sq_norm([t.to_local() for t in ts])
        for d in dims:
            dist.all_reduce(part, group=ts[0].device_mesh.get_group(d))
        sq = sq + part
    return sq


def mean_over_ranks(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the ranks of `group` (None: every
    rank; one all_reduce)."""
    n = _group_size(group)
    if n == 1:
        return metrics
    import torch.distributed as dist

    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    return dict(zip(keys, flat.unbind()))


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank of `group`'s `x` (all of one shape), in rank order, by
    all_gather_into_tensor."""
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((_group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return list(out.chunk(_group_size(group)))


def whole(t: torch.Tensor, name: Optional[str] = None, tp=None) -> torch.Tensor:
    """A DTensor whole on every rank of its mesh (FSDP2's Shard(0), padded
    to equal chunks, by all_gather_into_tensor), or a plain tensor as it
    is; then, where `name` is a tp piece of `tp`
    (parallel/tensor_parallel.TensorParallel), every tp rank's piece joined
    into the whole tensor (mesh.tp_unshard). Collective for a DTensor and
    a tp piece."""
    local = _whole_dtensor(t) if is_dtensor(t) else t.detach()
    if tp is not None and name in tp.pieces:
        local = tp_unshard(name, _all_gather(local, tp.group))
    return local


def _whole_dtensor(t: torch.Tensor) -> torch.Tensor:
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


def full_state(tree: Mapping, tp=None) -> Optional[Dict]:
    """`tree` (name -> tensor, or nested dicts of them) gathered whole and
    moved to the CPU on rank 0; None on the other ranks, which must call it
    all the same (the gather is collective). `tp`: the tp record whose
    pieces (by name) are joined back (`whole`)."""
    primary = rank() == 0
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = full_state(v, tp)
            continue
        v = whole(v, k, tp)          # on every rank: the gather is collective
        out[k] = v.cpu() if primary else None
    return out if primary else None


def global_rows(draw, rows: Rows, shape, **kwargs) -> torch.Tensor:
    """draw((rows.count * shape[0],) + shape[1:], **kwargs) cut to this
    rank's rows: `shape` is this rank's."""
    full = draw((rows.count * shape[0],) + tuple(shape[1:]), **kwargs)
    return rows.take(full)


def all_gather_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Every data rank's rows of a batch split `rows.count` ways over
    `rows.group`, joined in rank order (each rank passes its own); `x`
    itself for one rank."""
    if rows.count == 1:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(rows.count)]
    dist.all_gather(parts, x.contiguous(), group=rows.group)
    return torch.cat(parts)


# ---- the tp conjugate pairs ---------------------------------------------------

class TPCopy(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the tp ranks
    (in fp32): a tensor whole on every tp rank that enters each rank's own
    compute (a column-parallel input, a slice of a whole param) gets the
    sum of the ranks' parts of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        s = g.float().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(s, group=ctx.group)
        return s.to(g.dtype), None


class TPReduce(torch.autograd.Function):
    """The partial sums of a row-parallel product (fp32) summed over the
    tp ranks; backward the identity (the sum is whole on every rank, and
    so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        s = x.float().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(s, group=group)
        return s

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPGather(torch.autograd.Function):
    """Every tp rank's block of the last dim joined in rank order; backward
    this rank's block of the gradient (the joined tensor feeds a compute
    that every tp rank repeats, so its gradient is the same on each)."""

    @staticmethod
    def forward(ctx, x, group, index: int):
        ctx.block = (index, x.shape[-1])
        return torch.cat(_all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        index, n = ctx.block
        return g.narrow(-1, index * n, n).contiguous(), None, None
