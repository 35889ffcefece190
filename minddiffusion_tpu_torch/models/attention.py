"""SD spatial transformer (port of minddiffusion_tpu/models/attention.py).

LDM module names: SpatialTransformer {norm, proj_in, transformer_blocks.i,
proj_out}; BasicTransformerBlock {attn1, attn2, ff.net.0.proj, ff.net.2,
norm1..3}; CrossAttention {to_q, to_k, to_v, to_out.0}. Self-attention then
cross-attention then a GEGLU feed-forward, each pre-LayerNorm with a
residual. GEGLU uses the tanh GELU (flax `nn.gelu`); the SpatialTransformer
GroupNorm uses eps 1e-6; proj_in/proj_out are linear (SD2,
`use_linear=True`) or 1x1 convs (SD1), which compute the same per-token
map but keep the LDM conv weight layout (O, I, 1, 1). Attention runs on
packed (B, N, heads * dim_head) tokens through ops/attention. Every linear
map computes in its input's dtype (`layers.Linear`). With `enable_lora`,
to_q, to_k, to_v and to_out.0 of every CrossAttention carry a rank-r
adapter (models/lora.LoRALinear: state names `<proj>.lora_a` (in, r),
`<proj>.lora_b` (r, out) beside the base `<proj>.weight`).

Under tensor parallelism (parallel/tensor_parallel.py) a CrossAttention
whose projections hold tp pieces computes this rank's channels of q, k, v,
attention on its heads (on every head, q, k, v gathered, where the heads
do not divide by tp), and to_out.0 row parallel; a FeedForward whose
GEGLU proj holds a piece ([x_r; gate_r]) computes its features, and
ff.net.2 (whole) takes their columns and sums over the tp ranks.

Two sampling savings of the JAX package: inside a `layers.hoisted` scope
a cross-attention computes to_k(context) and to_v(context) once for the
context tensor it is given (LoRA's projections the same way), and with
`cfg_fold` the first block runs its self-attention at batch B and
duplicates x to 2B just before the cross-attention, where the two guidance
halves first differ (models/unet.py).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.core.cfg import cfg_dup
from minddiffusion_tpu_torch.models.layers import (
    Conv1x1, GroupNorm32, LayerNormFp32, Linear, reuse)
from minddiffusion_tpu_torch.models.lora import LoRALinear
from minddiffusion_tpu_torch.ops.attention import packed_attention
from minddiffusion_tpu_torch.parallel.tensor_parallel import holds_piece


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None. No q/k/v
    bias, output projection with bias."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, attn_impl: Optional[str] = None,
                 lora: Optional[dict] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.attn_impl = attn_impl

        def proj(n_in, n_out, bias):
            return LoRALinear(n_in, n_out, bias, **lora) if lora else Linear(n_in, n_out, bias)

        self.to_q = proj(query_dim, inner, False)
        self.to_k = proj(context_dim or query_dim, inner, False)
        self.to_v = proj(context_dim or query_dim, inner, False)
        self.to_out = nn.Sequential(proj(inner, query_dim, True), nn.Identity())
        self.kv_cache: Optional[dict] = None     # a dict inside layers.hoisted

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp is not None and holds_piece(self.to_q):
            return self._forward_tp(x, context)
        q = self.to_q(x)
        if context is None:
            k, v = self.to_k(x), self.to_v(x)
        else:
            k, v = reuse(self.kv_cache, context,
                         lambda: (self.to_k(context), self.to_v(context)))
        out = packed_attention(q, k, v, self.heads, impl=self.attn_impl)
        return self.to_out(out)

    def _forward_tp(self, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
        tp = self.tp
        xc = tp.copy(x)
        cc = xc if context is None else tp.copy(context)
        q = tp.column_layer(xc, self.to_q)
        k, v = reuse(self.kv_cache if context is not None else None, context,
                     lambda: (tp.column_layer(cc, self.to_k), tp.column_layer(cc, self.to_v)))
        out = tp.attention(q, k, v, self.heads,
                           lambda q, k, v, h: packed_attention(q, k, v, h, impl=self.attn_impl))
        return tp.row(out, self.to_out[0])


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(),
                                 Linear(dim * mult, dim))

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.net[0].proj
        if self.tp is None or not holds_piece(proj):
            return self.net(x)
        h, gate = self.tp.column_layer(self.tp.copy(x), proj, parts=2).chunk(2, dim=-1)
        return self.tp.row(h * F.gelu(gate, approximate="tanh"), self.net[2])


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int], attn_impl: Optional[str] = None,
                 lora: Optional[dict] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head, attn_impl=attn_impl, lora=lora)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, attn_impl, lora)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cfg_fold: bool = False) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if cfg_fold:     # the halves first differ where the context enters
            x = cfg_dup(x)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in (linear, or 1x1 conv when not `use_linear`) ->
    blocks over the H*W tokens -> proj_out -> residual. NHWC in and out."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 attn_impl: Optional[str] = None, use_linear: bool = True,
                 lora: Optional[dict] = None):
        super().__init__()
        inner = heads * dim_head
        proj = Linear if use_linear else Conv1x1
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, attn_impl, lora)
            for _ in range(depth))
        self.proj_out = proj(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cfg_fold: bool = False) -> torch.Tensor:
        """`cfg_fold`: x at batch B, context at 2B; block 0 widens to 2B
        after its self-attention, and the residual is duplicated."""
        b, h, w, c = x.shape
        t = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for i, block in enumerate(self.transformer_blocks):
            t = block(t, context, cfg_fold=cfg_fold and i == 0)
        return self.proj_out(t).reshape(-1, h, w, c) + (cfg_dup(x) if cfg_fold else x)
