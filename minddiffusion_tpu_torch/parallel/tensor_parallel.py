"""Tensor parallelism on a model: what a module computes on its tp pieces
(the JAX package's "tp" mesh axis, minddiffusion_tpu/parallel/mesh.py
_TP_COL / _TP_ROW, where XLA inserts the collectives; here they are
written out).

`parallel/mesh.shard_params` gives every module with a `tp` attribute (SD's
CrossAttention and FeedForward, OpenCLIP's CausalSelfAttention and
ResidualAttentionBlock, GLIDE's XfBlock and GlideAttentionBlock) this
rank's `TensorParallel` record. A module whose projection holds a piece
computes on it; a module the rule left whole (its features do not divide
by tp) computes as in one process, the same on every tp rank.

Activations between the modules are whole on every tp rank. Inside one:

  * column parallel (to_q / to_k / to_v, in_proj, qkv, encoder_kv,
    mlp.c_fc, mlp_fc, GEGLU's proj): the input through `copy` (its
    gradient summed over the tp ranks), times this rank's rows of the
    weight, plus its block of the bias (whole on every rank, through
    `copy` too): this rank's block of the output features, block r of
    each part of a packed projection;
  * attention (`attention`): where the heads divide by tp, on this rank's
    heads (K1 / K4 take heads // tp); where they do not (SD2's 5 heads at
    C 320, GLIDE's 9 at C 576, at tp 2), q, k and v gathered whole, every
    head on every rank, and this rank's block of the output kept;
  * row parallel (to_out.0, out_proj, mlp.c_proj, mlp_proj, and the whole
    weights that consume split features: SD's ff.net.2, GLIDE's proj_out,
    taken at this rank's columns): fp32 partial products of the bf16
    operands summed over the tp ranks, then the bias once, then one cast;
  * LoRA (models/lora.py): lora_a / lora_b split where the rule splits
    them, (x A) gathered or reduced whole over the tp ranks.

So every param whole on every tp rank ends the backward with the same
whole gradient on each, and each piece with the gradient of its piece.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.parallel.collectives import TPCopy, TPGather, TPReduce
from minddiffusion_tpu_torch.parallel.mesh import tp_block


def holds_piece(layer) -> bool:
    """Whether a Linear holds a tp piece of its weight (the rule split it)."""
    return tuple(layer.weight.shape) != (layer.out_features, layer.in_features)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the tp axis: the tp process group, its index
    in it, the tp size, and every tp piece's whole shape by param name."""

    group: object
    index: int
    size: int
    pieces: Mapping[str, Tuple[int, ...]]

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return TPCopy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return TPReduce.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return TPGather.apply(x, self.group, self.index)

    def block(self, t: torch.Tensor, dim: int = -1, parts: int = 1) -> torch.Tensor:
        """This rank's block of each of `parts` tensors packed on `dim`."""
        return tp_block(t, dim % t.dim(), parts, self.index, self.size)

    def column(self, xc: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, parts: int = 1) -> torch.Tensor:
        """A column-parallel product: `xc` (the input through `copy`) times
        this rank's rows of the weight plus its block of the whole bias, in
        xc's dtype."""
        b = None if bias is None else self.block(self.copy(bias), 0, parts).to(xc.dtype)
        return F.linear(xc, weight.to(xc.dtype), b)

    def column_layer(self, xc: torch.Tensor, layer, parts: int = 1) -> torch.Tensor:
        """`column` of a Linear, with its LoRA adapter where it has one."""
        y = self.column(xc, layer.weight, layer.bias, parts)
        if getattr(layer, "lora_a", None) is not None:
            y = y + layer.column_delta(self, xc)
        return y

    def row(self, h: torch.Tensor, layer) -> torch.Tensor:
        """A row-parallel Linear on this rank's block `h` of its input
        features: the fp32 partial product of the bf16 operands (a whole
        weight taken at this rank's columns), LoRA's partial, summed over
        the tp ranks, the bias added once, one cast to h's dtype."""
        w = layer.weight
        if w.shape[1] == layer.in_features:
            w = self.block(self.copy(w), 1)
        y = F.linear(h.float(), w.to(h.dtype).float())
        if getattr(layer, "lora_a", None) is not None:
            y = y + layer.row_delta(self, h)
        y = self.reduce(y)
        if layer.bias is not None:
            y = y + layer.bias.to(h.dtype).float()
        return y.to(h.dtype)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  attend: Callable) -> torch.Tensor:
        """attend(q, k, v, heads) on this rank's block of the channels of
        (B, N, C) q, k, v: on its heads // tp heads where `heads` divides
        by tp, else on every head of q, k, v gathered whole, keeping this
        rank's block of the output. -> this rank's block of the output
        channels."""
        if heads % self.size == 0:
            return attend(q, k, v, heads // self.size)
        o = attend(self.gather(q), self.gather(k), self.gather(v), heads)
        return self.block(self.copy(o), -1)
