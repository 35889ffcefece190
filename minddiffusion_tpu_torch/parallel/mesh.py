"""The process grid and its placement rules (port of
minddiffusion_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` of devices with the axes
("dp", "fsdp", "tp") and lets XLA insert the collectives. The port runs
one process a GPU (`torchrun --nproc_per_node N`) and builds the same grid
over the process group with `torch.distributed.device_mesh`:

  * "dp": data parallel. The batch is split, the params are replicated,
    and the train step averages the gradient over the data ranks
    (parallel/collectives.py).
  * "fsdp": the params are sharded as well, by FSDP2 `fully_shard` on the
    networks' blocks (`shard_params`); the batch is split over dp x fsdp
    jointly, as JAX's `batch_sharding` does.
  * "tp": tensor parallel. `shard_params` replaces every param whose
    `param_spec` holds "tp" by this rank's 1/tp of it on the rule's dim
    (`tp_shard`), and the attention and FF modules compute on their pieces
    (parallel/tensor_parallel.py): column-parallel projections, attention
    on whole local heads (or on every head where the heads do not divide by
    tp), row-parallel products reduced over the tp ranks. Each tp rank of a
    data rank takes the same rows.

`param_spec` is the JAX rule (`_tp_dim` / `_param_spec`) as a pure function
of (LDM name, torch shape, mesh shape). Two things differ from the flax
params it was written for: the port's names are LDM state-dict names
(`ff.net.0.proj` where flax says `geglu`, `to_out.0` for `to_out`,
`attn.in_proj_weight` for `qkv`, `mlp.c_fc` for `mlp_fc`), and a torch
Linear weight is (out, in) where a flax Dense kernel is (in, out), a conv
weight (O, I, kh, kw) where flax has (kh, kw, I, O). So the rule walks the
dims in flax order (`flax_order`): column parallel is dim 0 of a Linear
weight, and FSDP's "largest divisible axis" breaks ties as flax does.

FSDP2 itself always shards dim 0 (padded where it does not divide): the
same arithmetic on another axis. `param_spec` stays the rule that
`tp_report` and the tests read. A tp piece of a packed projection (GEGLU's
[x; gate], OpenCLIP's in_proj [q; k; v], GLIDE's qkv [q | k | v] and
encoder_kv [k | v]) is block r of each part, not the contiguous block r
that XLA places: the rank's heads' q, k and v, or the x and gate of its
features. Its size is the rule's.

A node of the port stands for a host of the JAX package and a rank for a
device: the datasets shard by node (`data_layout`), and each of a node's
ranks keeps its rows of the node's batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

AXES = ("dp", "fsdp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1   # -1: all remaining ranks
    fsdp: int = 1
    tp: int = 1

    def resolve(self, n: Optional[int] = None) -> "MeshConfig":
        """The grid over `n` ranks (default: the process group's world size,
        1 without a group). Fails, as the JAX assertion does, where
        dp x fsdp x tp is not `n`."""
        n = n if n is not None else world_size()
        dp = self.dp if self.dp != -1 else n // (self.fsdp * self.tp)
        if dp * self.fsdp * self.tp != n:
            raise AssertionError(f"mesh {dp}x{self.fsdp}x{self.tp} != {n} devices")
        return MeshConfig(dp=dp, fsdp=self.fsdp, tp=self.tp)


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_mesh(config: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The (dp, fsdp, tp) DeviceMesh over the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = config.resolve()
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.tp), mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"dp", "fsdp", "tp"} sizes of a DeviceMesh, a resolved MeshConfig or
    a mapping of them."""
    if isinstance(mesh, MeshConfig):
        return {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp}
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# Tensor-parallel rules: the JAX fragments (_TP_COL = to_q, to_k, to_v, qkv,
# mlp_fc, geglu, encoder_kv; _TP_ROW = to_out, out_proj, mlp_proj) under the
# names they take in the port. SD's text encoder is OpenCLIP's (attn.in_proj
# for qkv, mlp.c_fc / mlp.c_proj); GLIDE's modules keep the flax names.
_TP_COL = ("to_q", "to_k", "to_v", "in_proj_weight", "qkv", "mlp_fc", "mlp.c_fc",
           "ff.net.0.proj", "encoder_kv")
_TP_ROW = ("to_out.0", "out_proj", "mlp_proj", "mlp.c_proj")


def _has(name: str, frags) -> bool:
    dotted = f".{name}."
    return any(f".{k}." in dotted for k in frags)


def flax_order(name: str, ndim: int) -> Tuple[int, ...]:
    """The torch dims of `name` in the order of the flax leaf they come
    from: a Linear weight (out, in) is a Dense kernel (in, out), a conv
    weight (O, I, kh, kw) a kernel (kh, kw, I, O); embeddings, norms,
    biases and LoRA's lora_a / lora_b keep their layout."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "in_proj_weight") and "embedding" not in name \
            and "label_emb" not in name:
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
    return tuple(range(ndim))


def tp_dim(name: str, shape) -> Optional[int]:
    """Which torch dim (if any) the tp axis shards for this param: the
    flax column (output features) or row (input features) dim."""
    if len(shape) != 2:
        return None
    order = flax_order(name, 2)
    if _has(name, _TP_COL):
        return order[1]
    if _has(name, _TP_ROW):
        return order[0]
    return None


def param_spec(name: str, shape, mesh) -> Tuple[Optional[str], ...]:
    """The placement of each torch dim of `name` (None, "fsdp" or "tp"): an
    optional tp split of the attention / FF projections, then fsdp on the
    largest remaining divisible dim (the first in flax order on a tie)."""
    sizes = mesh_shape(mesh)
    fsdp, tp = sizes["fsdp"], sizes["tp"]
    shape = tuple(shape)
    spec = [None] * len(shape)
    if tp > 1:
        td = tp_dim(name, shape)
        if td is not None and shape[td] % tp == 0:
            spec[td] = "tp"
    if fsdp > 1:
        best, best_size = None, 0
        for i in flax_order(name, len(shape)):
            d = shape[i]
            if spec[i] is None and d % fsdp == 0 and d > best_size:
                best, best_size = i, d
        if best is not None:
            spec[best] = "fsdp"
    return tuple(spec)


def tp_report(params: Mapping[str, torch.Tensor], mesh) -> dict:
    """What the tp axis shards, as data: the tp-sharded param names and the
    fraction of 2-D param bytes they cover (JAX `tp_report`). `params`:
    name -> tensor (a state dict or named parameters; meta tensors do)."""
    names, tp_bytes, total_2d_bytes = [], 0, 0
    for name, p in params.items():
        shape = tuple(p.shape)
        nbytes = p.numel() * p.element_size() if shape else 0
        if len(shape) == 2:
            total_2d_bytes += nbytes
        if "tp" in param_spec(name, shape, mesh):
            names.append(name)
            tp_bytes += nbytes
    frac = tp_bytes / total_2d_bytes if total_2d_bytes else 0.0
    return {"tp_params": len(names), "names": names, "tp_bytes": tp_bytes,
            "total_2d_bytes": total_2d_bytes, "bytes_fraction": frac}


def assert_tp_effective(params: Mapping[str, torch.Tensor], mesh,
                        min_bytes_fraction: float = 0.15) -> Optional[dict]:
    """Fail where a tp > 1 grid would leave the model (near-)replicated: a
    module rename that the name-fragment rules no longer match."""
    tp = mesh_shape(mesh)["tp"]
    if tp <= 1:
        return None
    rep = tp_report(params, mesh)
    if rep["tp_params"] == 0 or rep["bytes_fraction"] < min_bytes_fraction:
        raise ValueError(
            f"tp={tp} mesh but only {rep['tp_params']} params "
            f"({rep['bytes_fraction']:.1%} of 2D bytes) matched the TP rules "
            f"(_TP_COL/_TP_ROW name fragments in parallel/mesh.py). A module "
            f"rename has likely broken the sharding rules; the run would be "
            f"silently replicated over the tp axis.")
    return rep


# Packed projections: the tensors a fused weight holds back to back on its
# split dim (the rule's dim: the output features of a column-parallel
# weight and its bias).
_TP_PARTS = (("in_proj_weight", 3), ("qkv", 3), ("ff.net.0.proj", 2), ("encoder_kv", 2))


def tp_parts(name: str) -> int:
    """How many tensors `name` packs on its tp dim (1: not packed)."""
    return next((n for frag, n in _TP_PARTS if _has(name, (frag,))), 1)


def tp_block(t: torch.Tensor, dim: int, parts: int, index: int, tp: int) -> torch.Tensor:
    """Block `index` of `tp` of each of the `parts` tensors `t` packs on
    `dim`, joined: [a_r; b_r; ...]."""
    n = t.shape[dim]
    if n % (parts * tp):
        raise ValueError(f"{parts} parts of {n} do not split into {tp} blocks each")
    return torch.cat([p.chunk(tp, dim)[index] for p in t.chunk(parts, dim)], dim)


def tp_shard(name: str, tensor: torch.Tensor, index: int, tp: int) -> torch.Tensor:
    """Rank `index`'s piece of `name` on a tp axis of `tp`: its 1/tp on the
    rule's dim (block `index` of each packed part), or `tensor` itself
    where the rule does not split it."""
    spec = param_spec(name, tuple(tensor.shape), {"tp": tp})
    if "tp" not in spec:
        return tensor
    try:
        return tp_block(tensor, spec.index("tp"), tp_parts(name), index, tp)
    except ValueError as e:
        raise ValueError(f"{name}: the rule splits it over tp={tp}, but {e}") from None


def tp_unshard(name: str, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The inverse of `tp_shard`: every rank's piece of `name` (in tp rank
    order) joined back into the whole tensor."""
    td = tp_dim(name, pieces[0].shape)
    parts = tp_parts(name)
    split = [p.chunk(parts, td) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], td) for j in range(parts)], td)


# The blocks FSDP2 shards one by one (each is called as a module, so its
# hooks gather its params): SD's ResBlock / SpatialTransformer, OpenCLIP's
# ResidualAttentionBlock, GLIDE's ResBlock / GlideAttentionBlock / XfBlock.
FSDP_UNITS = ("ResBlock", "SpatialTransformer", "ResidualAttentionBlock",
              "GlideAttentionBlock", "XfBlock")


def shard_params(modules: Mapping[str, nn.Module], mesh,
                 prefixes: Optional[Mapping[str, str]] = None):
    """Place the networks on the grid, in place. Under tp > 1 every param
    whose `param_spec` holds "tp" becomes this rank's piece of it
    (`tp_shard`) and every module with a `tp` attribute computes on the
    pieces; every other param stays whole. Then, under fsdp > 1, every
    network that takes a gradient is sharded by FSDP2, block by block and
    then as a whole, over the dp x fsdp ranks of this rank's tp coordinate
    (HSDP, replicated over dp, where dp > 1 too). A network with no
    trainable param (the VAE) is not sharded by FSDP2. `prefixes`: the
    prefix of each network's param names (default "<key>."), the names
    the returned record uses. -> the tp record
    (parallel/tensor_parallel.TensorParallel), None under tp 1."""
    prefixes = prefixes if prefixes is not None else {k: f"{k}." for k in modules}
    named = {prefixes[k] + n: p for k, m in modules.items() for n, p in m.named_parameters()}
    assert_tp_effective(named, mesh)
    sizes = mesh_shape(mesh)
    tp = _place_tp(modules, named, mesh) if sizes["tp"] > 1 else None
    if sizes["fsdp"] == 1:
        return tp
    from torch.distributed.fsdp import fully_shard

    sub = mesh["fsdp"] if sizes["dp"] == 1 else mesh["dp", "fsdp"]
    for name, module in modules.items():
        if not any(p.requires_grad for p in module.parameters()):
            continue
        units = [m for m in module.modules() if type(m).__name__ in FSDP_UNITS]
        if not units:
            raise ValueError(f"{name}: no block of {FSDP_UNITS} to shard")
        for unit in units:
            fully_shard(unit, mesh=sub)
        fully_shard(module, mesh=sub)
    return tp


def _place_tp(modules: Mapping[str, nn.Module], named: Mapping[str, nn.Parameter], mesh):
    """Every tp param replaced by this rank's piece; the record set on
    every module that has a `tp` attribute."""
    from minddiffusion_tpu_torch.parallel.tensor_parallel import TensorParallel

    size = mesh_shape(mesh)["tp"]
    index = mesh.get_local_rank("tp")
    pieces = {n: tuple(p.shape) for n, p in named.items()
              if "tp" in param_spec(n, tuple(p.shape), mesh)}
    for n in named:                 # a LoRA adapter is split where its layer is
        if n.endswith((".lora_a", ".lora_b")):
            base = n.rsplit(".", 1)[0] + ".weight"
            if (n in pieces) != (base in pieces):
                raise NotImplementedError(
                    f"{n}: under tp={size} a LoRA adapter must be split where its layer "
                    "is (a rank that divides by tp, on a layer the rule splits)")
    with torch.no_grad():          # a copy: the view would keep the whole tensor alive
        for n in pieces:
            named[n].data = tp_shard(n, named[n].data, index, size).clone()
    tp = TensorParallel(mesh.get_group("tp"), index, size, pieces)
    for module in modules.values():
        for m in module.modules():
            if hasattr(type(m), "tp"):
                m.tp = tp
    return tp


def data_group(mesh):
    """The process group of this rank's data ranks: the dp x fsdp ranks of
    its tp coordinate (None, the whole world, where tp is 1 or there is no
    grid)."""
    sizes = mesh_shape(mesh) if mesh is not None else {"tp": 1}
    if sizes["tp"] == 1:
        return None
    if sizes["dp"] == 1:
        return mesh.get_group("fsdp")
    if sizes["fsdp"] == 1:
        return mesh.get_group("dp")
    return mesh["dp", "fsdp"]._flatten("dp_fsdp").get_group()


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's block of a batch split `count` ways (block `index`) over
    the ranks of `group` (None: the world)."""

    index: int = 0
    count: int = 1
    group: object = dataclasses.field(default=None, compare=False)

    def take(self, x, name: str = "batch"):
        b = x.shape[0]
        if b % self.count:
            raise ValueError(f"{name} of {b} rows does not divide over {self.count} ranks")
        n = b // self.count
        return x[self.index * n:(self.index + 1) * n]


def batch_sharding(mesh) -> Rows:
    """This rank's rows of a global batch split over dp x fsdp jointly (the
    JAX P(("dp", "fsdp"))): block d * fsdp + f of dp * fsdp, over the data
    group; every tp rank of a data rank takes the same rows."""
    if mesh is None:
        return Rows()
    sizes = mesh_shape(mesh)
    d, f, _ = mesh.get_coordinate()
    return Rows(d * sizes["fsdp"] + f, sizes["dp"] * sizes["fsdp"], data_group(mesh))


def shard_batch(batch: Mapping, mesh) -> Dict:
    """This rank's rows of every tensor of `batch` (dim 0)."""
    rows = batch_sharding(mesh)
    return {k: rows.take(v, k) for k, v in batch.items()}


def replicate(tree: Mapping[str, torch.Tensor], mesh=None) -> Mapping[str, torch.Tensor]:
    """Make every rank hold rank 0's tensors (an in-place broadcast of each
    one); a no-op without a process group."""
    if world_size() == 1:
        return tree
    import torch.distributed as dist

    with torch.no_grad():
        for t in tree.values():
            dist.broadcast(t.data if isinstance(t, nn.Parameter) else t, src=0)
    return tree


def data_layout() -> Tuple[int, int, int, int]:
    """(shard_index, shard_count, row_index, row_count): this rank's node
    and the node count (torchrun's GROUP_RANK; 0 / 1 without a process
    group), its local rank and the node's ranks. A dataset reads the
    node's shard and keeps the rank's rows of each batch."""
    world = world_size()
    if world == 1:
        return 0, 1, 0, 1
    r = rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    node = int(os.environ.get("GROUP_RANK", r // local))
    return node, world // local, r % local, local
