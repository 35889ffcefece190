"""Fréchet distance over CLIP image features (CLIP-FID; port of
minddiffusion_tpu/eval/fid.py).

Fit a Gaussian to the feature clouds of a generated set and a reference
set and report the Fréchet distance, with the CLIP image tower in place of
InceptionV3 (Kynkäänniemi et al. 2022). Features come from the scorer's
image tower on the device (`image_features_fn`); the Gaussian fit and the
Fréchet algebra are a copy of the JAX package's fp64 numpy:

    d² = |mu1 - mu2|² + tr(C1 + C2 - 2·sqrtm(C1 @ C2))

with the trace of the square root taken eigenvalue-wise on the symmetrized
product C1^{1/2} C2 C1^{1/2} (the spectrum of C1 C2, symmetric PSD).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaussian_stats(features) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) feature rows -> (mean (D,), covariance (D, D)) in fp64."""
    f = np.asarray(_host(features), np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"need (N>=2, D) features, got {f.shape}")
    # np.cov collapses D=1 to a 0-d array; keep the (D, D) contract
    return f.mean(axis=0), np.atleast_2d(np.cov(f, rowvar=False))


def _psd_sqrt(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Squared Fréchet distance between two Gaussians."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = float(((mu1 - mu2) ** 2).sum())
    s1 = _psd_sqrt(cov1)
    # eigvalsh of the symmetrized product: spectrum == spectrum(cov1 @ cov2)
    middle = s1 @ cov2 @ s1
    vals = np.clip(np.linalg.eigvalsh((middle + middle.T) / 2.0), 0.0, None)
    tr_sqrt = float(np.sqrt(vals).sum())
    return diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * tr_sqrt


def clip_fid(features_a, features_b) -> float:
    """FID between two (N, D) CLIP image-feature sets."""
    return frechet_distance(*gaussian_stats(features_a), *gaussian_stats(features_b))


def image_features_fn(config, device="cuda") -> Callable:
    """fn(scorer, images_uint8) -> (B, embed_dim) L2-normalized CLIP image
    features, fp32 on `device` (the scorer's). `config` is a
    `CLIPScoreConfig`; batches stream through fn and gather on the host
    before `clip_fid`."""
    from minddiffusion_tpu_torch.cli.common import resolve_device
    from minddiffusion_tpu_torch.eval.clip_score import preprocess_uint8

    device = resolve_device(str(device))

    @torch.inference_mode()
    def fn(scorer, images_uint8) -> torch.Tensor:
        images = torch.as_tensor(np.asarray(images_uint8)).to(device)
        return scorer.encode_image(preprocess_uint8(images, config.vision.image_size))

    return fn
