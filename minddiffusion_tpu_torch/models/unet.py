"""SD UNet denoiser (port of minddiffusion_tpu/models/unet.py), built from
the LDM structure with LDM module names (time_embed, input_blocks,
middle_block, output_blocks, out), so an LDM state dict loads strictly.

Public tensors are NHWC: x (B, H, W, C) latents, timesteps (B,) or (1,),
context (B, L, context_dim); eps comes back fp32. The activations run in
`compute_dtype` (bf16 over fp32 master weights in training), or in the
weights' dtype when it is None.

ResBlock: GN -> SiLU -> conv_in; + emb; GN -> SiLU -> conv_out; + skip.
Both GN+SiLU run as a per-(batch, channel) affine (GroupNorm32.affine) fed
to the 3x3 conv dispatch, so at the Winograd-gated shapes they are the
kernel's prologue; the embedding add is folded into the second affine. The
GLIDE (ADM) forms: `use_scale_shift_norm` splits the embedding projection
into (scale, shift) and feeds GN(h) (1 + scale) + shift to conv_out as the
affine (m0 (1 + scale), a0 (1 + scale) + shift); `up` / `down` normalize
first, then resample h and x (nearest 2x / 2x2 average), then run conv_in
with no prologue.

`num_classes` adds the LDM class-label embedding (`label_emb`, the 'adm'
conditioning) to the time embedding; `y` (B,) int labels. `cfg_fold` is
the CFG-prefix dedup of the JAX package (`forward`). `hoisted` opens the
sampling run's caches that MDT_HOIST allows (layers.hoisted).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.core.cfg import cfg_dup
from minddiffusion_tpu_torch.models.attention import SpatialTransformer
from minddiffusion_tpu_torch.models.layers import (
    Conv1x1, Conv3x3, GroupNorm32, Linear, avg_pool_2x, hoisted, hoisted_winograd,
    nearest_upsample_2x, reuse, timestep_embedding)
from minddiffusion_tpu_torch.utils.flags import flags


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = -1
    num_head_channels: int = -1
    transformer_depth: int = 1
    context_dim: int = 1024
    use_linear_in_transformer: bool = True
    attn_impl: Optional[str] = None
    num_classes: Optional[int] = None
    enable_lora: bool = False
    lora_rank: int = 4
    lora_alpha: float = 4.0

    def head_split(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head) at a channel width."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels

    @classmethod
    def sd2(cls, **kw) -> "UNetConfig":
        return cls(num_head_channels=64, context_dim=1024,
                   use_linear_in_transformer=True, **kw)

    @classmethod
    def sd1(cls, **kw) -> "UNetConfig":
        """Wukong-Huahua's SD1 UNet: 8 heads (head dim 40, 80, 160 at C 320,
        640, 1280), context 768, 1x1-conv proj_in/proj_out."""
        return cls(num_heads=8, context_dim=768, use_linear_in_transformer=False, **kw)

    @classmethod
    def sd1_inpaint(cls, **kw) -> "UNetConfig":
        """The 9-channel inpaint UNet: [x_t (4), mask (1), masked-image
        latent (4)] in."""
        return cls(in_channels=9, num_heads=8, context_dim=768,
                   use_linear_in_transformer=False, **kw)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False):
        super().__init__()
        if up and down:
            raise ValueError("a ResBlock resamples up or down, not both")
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(),
                                       Conv3x3(in_ch, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(),
                                        nn.Identity(), Conv3x3(out_ch, out_ch))
        self.skip_connection = (Conv1x1(in_ch, out_ch) if in_ch != out_ch
                                else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm_in, conv_in = self.in_layers[0], self.in_layers[2]
        if self.up or self.down:
            resample = nearest_upsample_2x if self.up else avg_pool_2x
            h = conv_in(resample(F.silu(norm_in(x))))
            x = resample(x)
        else:
            h = conv_in(x, gn=norm_in.affine(x))
        e = self.emb_layers(emb)
        norm_out, conv_out = self.out_layers[0], self.out_layers[3]
        if self.use_scale_shift_norm:
            scale, shift = e.float().chunk(2, dim=-1)
            m0, a0 = norm_out.affine(h)
            gn = (m0 * (1.0 + scale), a0 * (1.0 + scale) + shift)
        else:
            gn = norm_out.affine(h, emb=e)
        h = conv_out(h, gn=gn)
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv3x3(ch, ch, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class UNetModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(),
                                        Linear(emb_dim, emb_dim))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_dim)
        self.kv_cache: Optional[dict] = None     # the context's cast, inside `hoisted`
        lora = (dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha) if cfg.enable_lora
                else None)

        def transformer(ch):
            heads, dim_head = cfg.head_split(ch)
            return SpatialTransformer(ch, heads, dim_head, cfg.transformer_depth,
                                      cfg.context_dim, cfg.attn_impl,
                                      cfg.use_linear_in_transformer, lora)

        ds = 1
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv3x3(cfg.in_channels, mc)])])
        chans, ch = [mc], mc
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_dim), transformer(ch),
                                           ResBlock(ch, ch, emb_dim)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb_dim)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                block = nn.ModuleList(layers)
                if level and i == cfg.num_res_blocks:
                    ds //= 2
                    block.append(Upsample(ch))
                self.output_blocks.append(block)
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv3x3(ch, cfg.out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, cfg_fold: bool = False,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`cfg_fold` (CFG-prefix dedup): x and timesteps at batch B, context
        the [uncond; cond] fold at 2B. The network runs at B up to the first
        spatial transformer's cross-attention, where the halves first
        differ, then at 2B: the output is the model applied to [x; x] with
        the prefix computed once. It needs a context; class labels differ
        by half, so `y` refuses it."""
        cfg = self.config
        if cfg_fold:
            if context is None:
                raise ValueError("cfg_fold requires a cross-attention context")
            if y is not None:
                raise ValueError("cfg_fold is incompatible with class labels")
        dtype = self.compute_dtype or self.time_embed[0].weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.model_channels)
        emb = self.time_embed(t_emb.to(dtype))
        if cfg.num_classes is not None:
            if y is None:
                raise ValueError("num_classes is set but no class labels were given")
            emb = emb + self.label_emb(torch.as_tensor(y).to(emb.device)).to(dtype)
        h = x.to(dtype)
        if context is not None:
            context = reuse(self.kv_cache, context, lambda: context.to(dtype))
        fold = cfg_fold

        def run(block: nn.ModuleList, h):
            nonlocal emb, fold
            for layer in block:
                if isinstance(layer, ResBlock):
                    h = layer(h, emb)
                elif isinstance(layer, SpatialTransformer):
                    h = layer(h, context, cfg_fold=fold)
                    if fold:
                        # a batch-1 emb broadcasts against both halves as it is
                        emb = cfg_dup(emb) if emb.shape[0] > 1 else emb
                        fold = False
                else:
                    h = layer(h)
            return h

        hs = []
        for block in self.input_blocks:
            h = run(block, h)
            hs.append(h)
        h = run(self.middle_block, h)
        if fold:
            raise ValueError("cfg_fold requires at least one spatial transformer")
        for block in self.output_blocks:
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:     # pushed before the fold, at B
                skip = cfg_dup(skip)
            h = run(block, torch.cat([h, skip], dim=-1))
        h = self.out[2](F.silu(self.out[0](h)))
        return h.float()

    def hoisted(self):
        """The sampling run's caches that MDT_HOIST allows: the Winograd
        transforms (all but "0") and the cross-attention K/V ("kv")."""
        f = flags()
        return hoisted(self, wino=f.hoist, kv=f.hoist_kv)

    def hoisted_winograd(self):
        """Keep the Winograd transform U of every Winograd-routed conv from
        its first call on, for a whole sampling run (layers.hoisted_winograd)."""
        return hoisted_winograd(self)
