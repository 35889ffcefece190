"""KL autoencoder (port of minddiffusion_tpu/models/vae.py), with LDM module
names (encoder/decoder {conv_in, down.i / up.i, mid, norm_out, conv_out},
quant_conv, post_quant_conv). NHWC. GroupNorm eps 1e-6; the mid-block
AttnBlock is single-head attention through ops/attention (exact softmax).
The encoder exists so that a full LDM state dict loads strictly; txt2img
only decodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.models.layers import (
    Conv1x1, Conv3x3, GroupNorm32, nearest_upsample_2x)
from minddiffusion_tpu_torch.ops.attention import packed_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv3x3(in_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.nin_shortcut = Conv1x1(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q, self.k, self.v = Conv1x1(ch, ch), Conv1x1(ch, ch), Conv1x1(ch, ch)
        self.proj_out = Conv1x1(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, h * w, c) for m in (self.q, self.k, self.v))
        out = packed_attention(q, k, v, heads=1).reshape(b, h, w, c)
        return x + self.proj_out(out)


def _level(blocks, sample_name=None, sample=None) -> nn.Module:
    m = nn.Module()
    m.block = nn.ModuleList(blocks)
    if sample is not None:
        setattr(m, sample_name, sample)
    return m


def _mid(ch: int) -> nn.Module:
    m = nn.Module()
    m.block_1 = ResnetBlock(ch, ch)
    m.attn_1 = AttnBlock(ch)
    m.block_2 = ResnetBlock(ch, ch)
    return m


class _ConvSample(nn.Module):
    """Holds the `conv` of an LDM Upsample/Downsample."""

    def __init__(self, conv: Conv3x3):
        super().__init__()
        self.conv = conv


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = Conv3x3(cfg.in_channels, cfg.ch)
        levels, ch = [], cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            down = None
            if level != len(cfg.ch_mult) - 1:
                # the reference pads (0, 1) on both spatial axes, then a VALID stride-2 conv
                down = _ConvSample(Conv3x3(ch, ch, stride=2, pad=(0, 1, 0, 1)))
            levels.append(_level(blocks, "downsample", down))
        self.down = nn.ModuleList(levels)
        self.mid = _mid(ch)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv3x3(ch, 2 * cfg.z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for lvl in self.down:
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample.conv(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv3x3(cfg.z_channels, ch)
        self.mid = _mid(ch)
        levels = [None] * len(cfg.ch_mult)
        for level, mult in reversed(list(enumerate(cfg.ch_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            up = _ConvSample(Conv3x3(ch, ch)) if level != 0 else None
            levels[level] = _level(blocks, "upsample", up)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv3x3(ch, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for lvl in reversed(self.up):
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample.conv(nearest_upsample_2x(h))
        return self.conv_out(F.silu(self.norm_out(h))).float()


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv1x1(2 * config.z_channels, 2 * config.embed_dim)
        self.post_quant_conv = Conv1x1(config.embed_dim, config.z_channels)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, 3) in [-1, 1] -> moments (B, H/f, W/f, 2*embed_dim) fp32."""
        dtype = self.compute_dtype or self.post_quant_conv.weight.dtype
        return self.quant_conv(self.encoder(x.to(dtype))).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latent (B, h, w, embed_dim) -> image (B, H, W, 3) fp32."""
        dtype = self.compute_dtype or self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dtype)))
