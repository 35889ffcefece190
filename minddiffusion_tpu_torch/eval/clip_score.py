"""CLIP-score harness (port of minddiffusion_tpu/eval/clip_score.py):
score = 100 * cos(image embedding, text embedding) in the joint CLIP space.

The scorer owns both towers (models/clip_vision.CLIPVisionEncoder and a
pooled projection head over models/clip.CLIPTextEncoder), because diffusion
checkpoints carry only the text tower without the joint-space projection.
Weights come from an OpenCLIP or HF checkpoint through
io/clip_weights.convert_clip_checkpoint; no CLIP checkpoint is in the
repository, so everything here runs on seeded random weights until one is.

uint8 images (B, H, W, 3) -> `preprocess_uint8` (the full frame resized to
the tower's size with JAX's bicubic: Keys a = -0.5, antialiased when it
shrinks, which is torch's bicubic with antialias=True; then clipped to
[0, 1] and normalized) -> both towers -> cosine. Entry points run on the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minddiffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from minddiffusion_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

# OpenCLIP normalization constants
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_uint8(images, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) fp32 CLIP-normalized (the
    full frame, no center crop: generated images are square already)."""
    x = torch.as_tensor(images).float() / 255.0
    if tuple(x.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
        x = x.clamp(0.0, 1.0)
    mean, std = (torch.tensor(v, device=x.device) for v in (MEAN, STD))
    return (x - mean) / std


@dataclasses.dataclass(frozen=True)
class CLIPScoreConfig:
    vision: CLIPVisionConfig
    text: CLIPTextConfig

    @classmethod
    def vit_h14(cls) -> "CLIPScoreConfig":
        """OpenCLIP ViT-H/14 with its full text tower: 24 layers (SD2's
        encoder is the same tower cut to 23) and exact erf GELU."""
        return cls(vision=CLIPVisionConfig.vit_h14(),
                   text=CLIPTextConfig(width=1024, layers=24, heads=16, use_exact_gelu=True))

    @classmethod
    def vit_l14(cls) -> "CLIPScoreConfig":
        """OpenAI ViT-L/14 (the SD1 / Wukong pair): QuickGELU towers."""
        return cls(vision=CLIPVisionConfig.vit_l14(),
                   text=CLIPTextConfig(width=768, layers=12, heads=12, use_quick_gelu=True))

    @classmethod
    def tiny(cls) -> "CLIPScoreConfig":
        """Test-sized towers (the JAX tiny config)."""
        return cls(vision=CLIPVisionConfig.tiny(),
                   text=CLIPTextConfig(vocab_size=128, width=48, layers=2, heads=2,
                                       context_length=16))


class CLIPScorer(nn.Module):
    """images (CLIP-normalized, (B, H, W, 3)) + token ids -> per-pair score."""

    def __init__(self, config: CLIPScoreConfig):
        super().__init__()
        self.config = config
        self.visual = CLIPVisionEncoder(config.vision)
        self.text = CLIPTextEncoder(config.text)
        # pooled text head: the EOT position of the final-LN sequence,
        # projected into the joint space (OpenCLIP text_projection)
        self.text_projection = nn.Parameter(
            torch.randn(config.text.width, config.vision.embed_dim) * config.text.width ** -0.5)

    @classmethod
    def create(cls, config: CLIPScoreConfig, device="cuda",
               generator: Optional[torch.Generator] = None,
               compute_dtype: Optional[torch.dtype] = None) -> "CLIPScorer":
        """fp32 weights on `device`: seeded random ones from `generator`
        (the SD init's scales), else zero until `load_state_dict`.
        `compute_dtype` sets both towers' activation dtype (None: fp32)."""
        from minddiffusion_tpu_torch.cli.common import resolve_device
        from minddiffusion_tpu_torch.pipelines.stable_diffusion import init_random_

        device = resolve_device(str(device))
        with torch.device("meta"):
            scorer = cls(config)
        scorer.to_empty(device=device)
        if generator is not None:
            init_random_(scorer, generator)
        else:
            for p in scorer.parameters():
                p.detach().zero_()
        scorer.visual.compute_dtype = scorer.text.compute_dtype = compute_dtype
        return scorer.eval()

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        emb = self.visual(images)
        return emb / emb.norm(dim=-1, keepdim=True)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        seq = self.text(tokens)                                 # (B, L, W) fp32
        eot = tokens.argmax(dim=-1)                             # EOT: the highest id
        pooled = seq[torch.arange(seq.shape[0], device=seq.device), eot]
        emb = pooled @ self.text_projection.float()
        return emb / emb.norm(dim=-1, keepdim=True)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Pairwise score (B,): 100 * cos(image_i, text_i)."""
        return 100.0 * (self.encode_image(images) * self.encode_text(tokens)).sum(dim=-1)


def clip_score_fn(config: CLIPScoreConfig, device="cuda",
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[CLIPScorer, Callable]:
    """(scorer on `device`, fn(scorer, images_uint8, tokens) -> (B,) scores).
    The scorer's weights are `generator`'s random ones or zero: load a
    converted checkpoint into it (`io/clip_weights`)."""
    scorer = CLIPScorer.create(config, device, generator)

    @torch.inference_mode()
    def fn(scorer: CLIPScorer, images_uint8, tokens) -> torch.Tensor:
        dev = scorer.text_projection.device
        images = preprocess_uint8(torch.as_tensor(np.asarray(images_uint8)).to(dev),
                                  config.vision.image_size)
        return scorer(images, torch.as_tensor(np.asarray(tokens)).to(dev))

    return scorer, fn
