"""CLIP ViT image tower (port of minddiffusion_tpu/models/clip_vision.py),
in OpenCLIP module names (conv1, class_embedding, positional_embedding,
ln_pre, transformer.resblocks.i, ln_post, proj), so OpenCLIP weights load
by name (io/clip_weights.py).

images (B, H, W, 3) CLIP-normalized, the JAX layout -> (B, embed_dim) fp32:
patchify as one stride-P conv without bias, a class token and the
positional embedding, pre-LN, the blocks of models/clip.py without a mask
(exact erf GELU for the laion ViT-H/14, QuickGELU for the OpenAI ViT-L/14),
the fp32 LayerNorm of the class token, and the projection. Activations run
in `compute_dtype`, or in the weights' dtype when it is None; the
LayerNorms in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.models.clip import ResidualAttentionBlock
from minddiffusion_tpu_torch.models.layers import LayerNormFp32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024          # the joint text / image space
    use_quick_gelu: bool = False   # OpenAI-trained towers (L/14); laion H/14: erf GELU

    @classmethod
    def vit_h14(cls, **kw) -> "CLIPVisionConfig":
        """OpenCLIP ViT-H/14 (the SD2 text encoder's pair)."""
        return cls(width=1280, layers=32, heads=16, embed_dim=1024, **kw)

    @classmethod
    def vit_l14(cls, **kw) -> "CLIPVisionConfig":
        """OpenAI / OpenCLIP ViT-L/14 (the SD1 and Wukong pair)."""
        kw.setdefault("use_quick_gelu", True)
        return cls(width=1024, layers=24, heads=16, embed_dim=768, **kw)

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        """The test-sized tower of the JAX `CLIPScoreConfig.tiny`."""
        return cls(image_size=32, patch_size=8, width=64, layers=2, heads=2, embed_dim=32,
                   **kw)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


class CLIPVisionEncoder(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.compute_dtype: Optional[torch.dtype] = None   # None: the weights' dtype
        w = config.width
        self.conv1 = nn.Conv2d(3, w, config.patch_size, stride=config.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(w) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(config.grid ** 2 + 1, w) * 0.01)
        self.ln_pre = LayerNormFp32(w)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(w, config.heads, config.use_quick_gelu,
                                   not config.use_quick_gelu)
            for _ in range(config.layers))
        self.ln_post = LayerNormFp32(w)
        self.proj = nn.Parameter(torch.randn(w, config.embed_dim) * w ** -0.5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.conv1.weight.dtype
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt), self.conv1.weight.to(dt),
                     stride=self.config.patch_size)
        x = x.flatten(2).transpose(1, 2)                       # (B, grid^2, W), row-major
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x, None)
        pooled = self.ln_post(x[:, 0])
        return (pooled @ self.proj.to(dt)).float()
