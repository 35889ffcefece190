"""SRGAN generator of the GLIDE cascade's x4 upscale, 256 -> 1024 px (port
of minddiffusion_tpu/models/srgan.py).

9x9 conv + PReLU head, 16 residual blocks (conv-BN-PReLU-conv-BN + skip),
3x3 conv + PReLU with the global skip, log2(scale) stages of a 3x3 conv to
4C channels, a depth-to-space by 2 and a PReLU, then a plain 9x9 conv to 3
channels and tanh. Inference only: each BatchNorm applies its stored
statistics (eps 1e-5). Module and parameter names are the flax ones
(`res_3.bn1.scale`, `bn1.mean`, `prelu.alpha`, ...).

Public tensors are NHWC; the convolutions run NCHW. `pixel_shuffle_2x`
keeps the JAX package's channel order, channel (2 i + j) * C/4 + k to
sub-pixel (i, j), which is not `F.pixel_shuffle`'s k * 4 + 2 i + j.

Precision: the generator runs in fp32, as the reference does, and its
convolutions run with cuDNN's TF32 switched off inside `forward` (the
caller's `torch.backends.cudnn.allow_tf32` is restored after it; no other
cuDNN setting is touched), so the result does not depend on that switch.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def pixel_shuffle_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC depth-to-space by 2 in the JAX order: (B, H, W, C) ->
    (B, 2H, 2W, C/4), channel (2 i + j) * C/4 + k to pixel (2h + i, 2w + j)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c // 4)


class PReLU(nn.Module):
    """Per-channel parametric ReLU on the last axis."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class BatchNorm(nn.Module):
    """Inference BatchNorm on the last axis from stored statistics:
    (x - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias


class Conv(nn.Conv2d):
    """SAME-padded square conv on NHWC tensors."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__(in_ch, out_ch, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SRResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3)
        self.bn1 = BatchNorm(channels)
        self.prelu = PReLU(channels)
        self.conv2 = Conv(channels, channels, 3)
        self.bn2 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(h)) + x


class SRGANGenerator(nn.Module):
    def __init__(self, upscale_factor: int = 4, channels: int = 64, n_res: int = 16):
        super().__init__()
        c = channels
        self.n_res, self.n_up = n_res, int(math.log2(upscale_factor))
        self.conv1 = Conv(3, c, 9)
        self.prelu1 = PReLU(c)
        for i in range(n_res):
            self.add_module(f"res_{i}", SRResBlock(c))
        self.conv2 = Conv(c, c, 3)
        self.prelu2 = PReLU(c)
        for i in range(self.n_up):
            self.add_module(f"up_{i}_conv", Conv(c, 4 * c, 3))
            self.add_module(f"up_{i}_prelu", PReLU(c))
        self.conv3 = Conv(c, 3, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) fp32 -> (B, sH, sW, 3) in (-1, 1)."""
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            h0 = self.prelu1(self.conv1(x.float()))
            h = h0
            for i in range(self.n_res):
                h = getattr(self, f"res_{i}")(h)
            h = self.prelu2(self.conv2(h)) + h0
            for i in range(self.n_up):
                h = getattr(self, f"up_{i}_prelu")(
                    pixel_shuffle_2x(getattr(self, f"up_{i}_conv")(h)))
            return torch.tanh(self.conv3(h))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
