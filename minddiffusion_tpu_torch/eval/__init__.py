"""Quantitative evaluation: the CLIP-score and CLIP-FID harness (port of
minddiffusion_tpu/eval)."""
from minddiffusion_tpu_torch.eval.clip_score import (  # noqa: F401
    CLIPScoreConfig,
    CLIPScorer,
    clip_score_fn,
    preprocess_uint8,
)
from minddiffusion_tpu_torch.eval.fid import (  # noqa: F401
    clip_fid,
    frechet_distance,
    gaussian_stats,
    image_features_fn,
)
