"""CLIP causal text transformer (port of minddiffusion_tpu/models/clip.py),
with OpenCLIP module names (token_embedding, positional_embedding,
transformer.resblocks.i {ln_1, attn.in_proj_*, attn.out_proj, ln_2,
mlp.c_fc, mlp.c_proj}, ln_final).

Presets: SD2 (`sd2_en`) width 1024, 23 layers, 16 heads, tanh GELU;
Wukong-Huahua (`wukong_zh`) width 768, 12 layers, 12 heads, QuickGELU
x * sigmoid(1.702 x), over the zh wordpiece vocabulary (ids below 21128
of the 49408-row embedding). `use_exact_gelu` takes the erf GELU of the
OpenCLIP towers that the eval scorer carries (eval/clip_score.py); the
blocks also serve the ViT image tower (models/clip_vision.py), unmasked. Token ids outside
the vocabulary are clipped to it (JAX `take(..., mode='clip')`). Returns the
full final-LayerNorm sequence (B, L, width) in fp32: the UNet's context.
The activations run in `compute_dtype`, or in the weights' dtype when it is
None.

Under tensor parallelism (parallel/tensor_parallel.py) an attention whose
in_proj_weight holds a tp piece reads it as [q_r; k_r; v_r] with the same
blocks of the whole in_proj_bias, attends on its heads // tp heads (every
head, gathered, where they do not divide), and out_proj is row parallel;
an MLP whose c_fc holds a piece is column parallel there and row parallel
at c_proj.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.models.layers import LayerNormFp32, Linear
from minddiffusion_tpu_torch.ops.attention import einsum_attention
from minddiffusion_tpu_torch.parallel.tensor_parallel import holds_piece


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    layers: int = 23
    heads: int = 16
    context_length: int = 77
    use_quick_gelu: bool = False
    use_exact_gelu: bool = False

    @classmethod
    def sd2_en(cls, **kw) -> "CLIPTextConfig":
        return cls(width=1024, layers=23, heads=16, use_quick_gelu=False, **kw)

    @classmethod
    def wukong_zh(cls, **kw) -> "CLIPTextConfig":
        return cls(width=768, layers=12, heads=12, use_quick_gelu=True, **kw)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CausalSelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Linear(width, width)

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, w = x.shape

        def attend(q, k, v, heads):
            q, k, v = (t.reshape(b, l, heads, -1) for t in (q, k, v))
            return einsum_attention(q, k, v, bias=bias).reshape(b, l, -1)

        tp = self.tp
        if tp is not None and self.in_proj_weight.shape[0] != 3 * w:
            q, k, v = tp.column(tp.copy(x), self.in_proj_weight, self.in_proj_bias,
                                parts=3).chunk(3, dim=-1)
            return tp.row(tp.attention(q, k, v, self.heads, attend), self.out_proj)
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        return self.out_proj(attend(*qkv.chunk(3, dim=-1), self.heads))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; `bias` is the additive attention bias (the causal mask)
    or None."""

    def __init__(self, width: int, heads: int, use_quick_gelu: bool = False,
                 use_exact_gelu: bool = False):
        super().__init__()
        self.use_quick_gelu, self.use_exact_gelu = use_quick_gelu, use_exact_gelu
        self.ln_1 = LayerNormFp32(width)
        self.attn = CausalSelfAttention(width, heads)
        self.ln_2 = LayerNormFp32(width)
        self.mlp = nn.Module()
        self.mlp.c_fc = Linear(width, 4 * width)
        self.mlp.c_proj = Linear(4 * width, width)

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        tp = self.tp if self.tp is not None and holds_piece(self.mlp.c_fc) else None
        y = self.ln_2(x)
        h = self.mlp.c_fc(y) if tp is None else tp.column_layer(tp.copy(y), self.mlp.c_fc)
        if self.use_quick_gelu:
            h = quick_gelu(h)
        else:
            h = F.gelu(h, approximate="none" if self.use_exact_gelu else "tanh")
        return x + (self.mlp.c_proj(h) if tp is None else tp.row(h, self.mlp.c_proj))


class CLIPTextEncoder(nn.Module):
    """token ids (B, L) -> (B, L, width) fp32 final-LN sequence."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        self.token_embedding = nn.Embedding(config.vocab_size, config.width)
        self.positional_embedding = nn.Parameter(
            torch.randn(config.context_length, config.width) * 0.01)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(config.width, config.heads, config.use_quick_gelu,
                                   config.use_exact_gelu)
            for _ in range(config.layers))
        self.ln_final = LayerNormFp32(config.width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        ids = tokens.long().clamp(0, self.config.vocab_size - 1)
        x = self.token_embedding(ids).to(self.compute_dtype or self.token_embedding.weight.dtype)
        l = x.shape[1]
        x = x + self.positional_embedding[:l].to(x.dtype)
        causal = torch.full((l, l), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, causal[None, None])
        return self.ln_final(x).float()
