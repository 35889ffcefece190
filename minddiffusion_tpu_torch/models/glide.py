"""Taichu-GLIDE models (port of minddiffusion_tpu/models/glide.py): the xf
text transformer, the ADM UNet whose attention prepends the projected text
tokens to its keys and values, and the base / super-res Text2Im wrappers.

Module names follow the flax tree (`xf.block_3.qkv`, `unet.down_1_2_attn`,
`unet.up_2_3_us`, ...), so io/glide_weights.py maps the JAX params
mechanically; inside a ResBlock the port keeps its LDM names (in_layers,
emb_layers, out_layers, skip_connection). Public tensors are NHWC; eps and
v come back fp32.

  * xf: pre-LN blocks with a fused qkv split into [q | k | v] columns, the
    tanh GELU (flax `nn.gelu`), no causal mask; token ids clamped into the
    vocabulary (`mode='clip'`; `debug_tokens` raises instead); the padding
    embedding where mask == 0; `transformer_proj` of the last token.
  * GlideAttentionBlock: GN -> qkv -> [encoder K/V; spatial K/V] ->
    `packed_attention(block_q=1024, min_q=MDT_GLIDE_TUNE attn_route)` ->
    proj_out -> residual. Inside a `hoisted` scope the encoder K/V of one
    xf encoding are computed once (layers.reuse).
  * The up path joins each skip by channel concatenation.
  * Super-res: the low-res image bilinearly resized in fp32 (half-pixel
    centres, edge-clamped: torch's align_corners=False equals
    `jax.image.resize` when upsampling) and concatenated as [x, up].

Under tensor parallelism (parallel/tensor_parallel.py) qkv ([q_r | k_r |
v_r]), encoder_kv ([k_r | v_r]) and mlp_fc are column parallel where they
hold tp pieces, out_proj and mlp_proj row parallel, and the whole proj_out
takes the rank's columns of the attention output and sums over the tp
ranks; the attention runs on the rank's heads, or on every head gathered
where they do not divide by tp (the base UNet's 9 heads at C 576, tp 2).

The activations run in `compute_dtype` (bf16 over fp32 master weights in
training, as the JAX GLIDE configs' dtype=bf16 over fp32 params), or in the
weights' dtype when it is None. Every Linear and conv casts its weight to
the activation dtype at use; the norms compute in fp32 and return the
activation dtype, as the JAX modules do. Setting `compute_dtype` on a
Text2Im model sets it on its xf and its UNet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.models.layers import (
    Conv3x3, GroupNorm32, LayerNormFp32, Linear, hoisted, hoisted_winograd, reuse,
    timestep_embedding)
from minddiffusion_tpu_torch.models.unet import ResBlock
from minddiffusion_tpu_torch.ops.attention import packed_attention
from minddiffusion_tpu_torch.parallel.tensor_parallel import holds_piece
from minddiffusion_tpu_torch.utils.flags import flags

GLIDE_BLOCK_Q = 1024   # the q-tile hint GLIDE's attention passes to the route


@dataclasses.dataclass(frozen=True)
class XfConfig:
    width: int = 512
    layers: int = 16
    heads: int = 8
    text_ctx: int = 128
    n_vocab: int = 50001
    debug_tokens: bool = False


class XfBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNormFp32(width)
        self.qkv = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)
        self.ln_2 = LayerNormFp32(width)
        self.mlp_fc = Linear(width, 4 * width)
        self.mlp_proj = Linear(4 * width, width)

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp, y = self.tp, self.ln_1(x)
        if tp is not None and holds_piece(self.qkv):
            q, k, v = tp.column_layer(tp.copy(y), self.qkv, parts=3).chunk(3, dim=-1)
            x = x + tp.row(tp.attention(q, k, v, self.heads, packed_attention), self.out_proj)
        else:
            q, k, v = self.qkv(y).chunk(3, dim=-1)
            x = x + self.out_proj(packed_attention(q, k, v, self.heads))
        y = self.ln_2(x)
        if tp is not None and holds_piece(self.mlp_fc):
            h = F.gelu(tp.column_layer(tp.copy(y), self.mlp_fc), approximate="tanh")
            return x + tp.row(h, self.mlp_proj)
        return x + self.mlp_proj(F.gelu(self.mlp_fc(y), approximate="tanh"))


class XfTextEncoder(nn.Module):
    """tokens (B, L) + mask (B, L) -> (xf_proj (B, proj_dim), xf_out (B, L, W))."""

    def __init__(self, config: XfConfig, proj_dim: int):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        self.token_embedding = nn.Parameter(torch.zeros(cfg.n_vocab, cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.text_ctx, cfg.width))
        self.padding_embedding = nn.Parameter(torch.zeros(cfg.text_ctx, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", XfBlock(cfg.width, cfg.heads))
        self.final_ln = LayerNormFp32(cfg.width)
        self.transformer_proj = Linear(cfg.width, proj_dim)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor):
        cfg = self.config
        dtype = self.compute_dtype or self.transformer_proj.weight.dtype
        tokens = torch.as_tensor(tokens).to(self.token_embedding.device, torch.int64)
        if cfg.debug_tokens and ((tokens < 0).any() or (tokens >= cfg.n_vocab).any()):
            raise ValueError(f"token id out of range [0, {cfg.n_vocab}): "
                             f"min={int(tokens.min())} max={int(tokens.max())}")
        x = self.token_embedding[tokens.clamp(0, cfg.n_vocab - 1)].to(dtype)
        x = x + self.positional_embedding[None].to(dtype)
        keep = torch.as_tensor(mask).to(x.device).bool()[..., None]
        x = torch.where(keep, x, self.padding_embedding[None].to(dtype))
        for i in range(cfg.layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.final_ln(x)
        return self.transformer_proj(x[:, -1]), x


class GlideAttentionBlock(nn.Module):
    """Self-attention over the spatial tokens with the projected encoder
    tokens prepended to K and V: one attention over Nk = L_text + H*W."""

    def __init__(self, channels: int, heads: int, encoder_channels: Optional[int],
                 attn_impl: Optional[str] = None):
        super().__init__()
        self.heads, self.attn_impl = heads, attn_impl
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels)
        if encoder_channels is not None:
            self.encoder_kv = Linear(encoder_channels, 2 * channels)
            self.kv_cache: Optional[dict] = None    # a dict inside layers.hoisted
        self.proj_out = Linear(channels, channels)

    tp = None        # parallel/tensor_parallel.TensorParallel, set by parallel.shard_params

    def forward(self, x: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        tp = self.tp if self.tp is not None and holds_piece(self.qkv) else None

        def project(layer, t, parts):
            return layer(t) if tp is None else tp.column_layer(tp.copy(t), layer, parts)

        q, k, v = project(self.qkv, self.norm(x).reshape(b, h * w, c), 3).chunk(3, dim=-1)
        if encoder_out is not None:
            ek, ev = reuse(self.kv_cache, encoder_out, lambda: project(
                self.encoder_kv, encoder_out.to(x.dtype), 2).chunk(2, dim=-1))
            k, v = torch.cat([ek, k], dim=1), torch.cat([ev, v], dim=1)

        def attend(q, k, v, heads):
            return packed_attention(q, k, v, heads, impl=self.attn_impl,
                                    block_q=GLIDE_BLOCK_Q, min_q=flags().glide_attn_route)

        if tp is None:
            out = self.proj_out(attend(q, k, v, self.heads))
        else:
            out = tp.row(tp.attention(q, k, v, self.heads, attend), self.proj_out)
        return x + out.reshape(b, h, w, c)


@dataclasses.dataclass(frozen=True)
class GlideUNetConfig:
    in_channels: int = 3
    model_channels: int = 192
    out_channels: int = 6          # eps + learned variance
    num_res_blocks: int = 3
    attention_resolutions: Tuple[int, ...] = (2, 4, 8)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    attn_impl: Optional[str] = None

    @classmethod
    def base_64(cls, **kw) -> "GlideUNetConfig":
        return cls(**kw)

    @classmethod
    def upsample_256(cls, **kw) -> "GlideUNetConfig":
        kw.setdefault("in_channels", 6)
        kw.setdefault("num_res_blocks", 2)
        kw.setdefault("channel_mult", (1, 1, 2, 2, 4, 4))
        kw.setdefault("attention_resolutions", (8, 16, 32))
        return cls(**kw)


class GlideUNet(nn.Module):
    """ADM UNet; emb already holds xf_proj; encoder_out is the attention memory."""

    def __init__(self, config: GlideUNetConfig, encoder_channels: Optional[int]):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        mc, emb_dim = cfg.model_channels, cfg.model_channels * 4

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(cin, cout, emb_dim,
                                           cfg.use_scale_shift_norm, **kw))

        def attn(name, ch):
            self.add_module(name, GlideAttentionBlock(
                ch, ch // cfg.num_head_channels, encoder_channels, cfg.attn_impl))

        ch = mc * cfg.channel_mult[0]
        self.in_conv = Conv3x3(cfg.in_channels, ch)
        chans, ds = [ch], 1
        last = len(cfg.channel_mult) - 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                res(f"down_{level}_{i}_res", ch, mult * mc)
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    attn(f"down_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != last:
                res(f"down_{level}_ds", ch, ch, down=True)
                chans.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch)
        res("mid_res2", ch, ch)
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                res(f"up_{level}_{i}_res", ch + chans.pop(), mult * mc)
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    attn(f"up_{level}_{i}_attn", ch)
                if level and i == cfg.num_res_blocks:
                    res(f"up_{level}_us", ch, ch, up=True)
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv3x3(ch, cfg.out_channels)

    def _block(self, name: str, h, emb, encoder_out):
        m = getattr(self, name)
        if isinstance(m, ResBlock):
            return m(h, emb)
        return m(h, encoder_out)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        h = self.in_conv(x.to(self.compute_dtype or self.in_conv.weight.dtype))
        hs, ds = [h], 1
        last = len(cfg.channel_mult) - 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = self._block(f"down_{level}_{i}_res", h, emb, encoder_out)
                if ds in cfg.attention_resolutions:
                    h = self._block(f"down_{level}_{i}_attn", h, emb, encoder_out)
                hs.append(h)
            if level != last:
                h = self._block(f"down_{level}_ds", h, emb, encoder_out)
                hs.append(h)
                ds *= 2
        for name in ("mid_res1", "mid_attn", "mid_res2"):
            h = self._block(name, h, emb, encoder_out)
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = self._block(f"up_{level}_{i}_res", h, emb, encoder_out)
                if ds in cfg.attention_resolutions:
                    h = self._block(f"up_{level}_{i}_attn", h, emb, encoder_out)
                if level and i == cfg.num_res_blocks:
                    h = self._block(f"up_{level}_us", h, emb, encoder_out)
                    ds //= 2
        h = self.out_conv(F.silu(self.out_norm(h)))
        return h.float()


class Text2ImUNet(nn.Module):
    """GLIDE base model: (x, t, tokens, mask) -> (eps, v), each (B, H, W, 3).
    `encode_text` and `denoise` are separate, so a sampler runs the xf once
    per generation."""

    def __init__(self, unet_config: GlideUNetConfig, xf_config: XfConfig):
        super().__init__()
        mc = unet_config.model_channels
        self.unet_config, self.xf_config = unet_config, xf_config
        self.xf = XfTextEncoder(xf_config, mc * 4)
        self.unet = GlideUNet(unet_config, xf_config.width)
        self.time_embed_0 = Linear(mc, mc * 4)
        self.time_embed_2 = Linear(mc * 4, mc * 4)

    @property
    def device(self) -> torch.device:
        return self.time_embed_0.weight.device

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return self.unet.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.xf.compute_dtype = self.unet.compute_dtype = dtype

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype."""
        return self.compute_dtype or self.time_embed_0.weight.dtype

    def encode_text(self, tokens, mask):
        return self.xf(tokens, mask)

    def _time_emb(self, timesteps: torch.Tensor) -> torch.Tensor:
        t_emb = timestep_embedding(timesteps, self.unet_config.model_channels)
        return self.time_embed_2(F.silu(self.time_embed_0(t_emb.to(self.dtype))))

    def denoise(self, x, timesteps, xf_proj, xf_out):
        emb = self._time_emb(timesteps) + xf_proj.to(self.dtype)
        return self.unet(x, emb, xf_out).chunk(2, dim=-1)

    def forward(self, x, timesteps, tokens, mask):
        xf_proj, xf_out = self.encode_text(tokens, mask)
        return self.denoise(x, timesteps, xf_proj, xf_out)

    def hoisted_winograd(self):
        return hoisted_winograd(self)

    def hoisted(self, kv: bool = True):
        """The sampling run's caches that MDT_HOIST allows: the encoder K/V
        (`kv` and "kv") and the Winograd transforms ("wino"; under "1" too,
        unlike the JAX package). A stage whose encoding changes every step
        passes kv=False."""
        f = flags()
        return hoisted(self, wino=f.hoist_wino_glide, kv=kv and f.hoist_kv)


class SuperResText2ImUNet(Text2ImUNet):
    """GLIDE super-res: [x, bilinear-upsampled low_res] in, (eps, v) out."""

    def denoise(self, x, timesteps, low_res, xf_proj, xf_out):
        b, h, w, _ = x.shape
        up = F.interpolate(low_res.float().permute(0, 3, 1, 2), size=(h, w),
                           mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        x = torch.cat([x.float(), up], dim=-1)
        return super().denoise(x, timesteps, xf_proj, xf_out)

    def forward(self, x, timesteps, low_res, tokens, mask):
        xf_proj, xf_out = self.encode_text(tokens, mask)
        return self.denoise(x, timesteps, low_res, xf_proj, xf_out)
