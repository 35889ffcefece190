"""Public CLIP checkpoints (OpenCLIP or HuggingFace layout) -> the state dict
of eval.clip_score.CLIPScorer (port of minddiffusion_tpu/io/clip_weights.py).

The eval harness needs both CLIP towers with their joint-space
projections, which diffusion checkpoints do not carry. SD2's pair is the
laion OpenCLIP ViT-H/14 release, published in two layouts:

  OpenCLIP: visual.conv1.weight, visual.transformer.resblocks.{i}.attn.
            in_proj_weight/out_proj, visual.proj, token_embedding.weight,
            transformer.resblocks.{i}.*, ln_final, text_projection
  HF hub:   vision_model.embeddings.*, vision_model.encoder.layers.{i}.
            self_attn.{q,k,v}_proj, visual_projection.weight,
            text_model.encoder.layers.{i}.*, text_projection.weight

The layout is detected from the names. The scorer's modules carry OpenCLIP
names (text tower under `text.`), so OpenCLIP maps by name; HF's separate
q / k / v projections are stacked into in_proj (rows q, k, v) and its
(embed, width) projections transposed to OpenCLIP's (width, embed).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_BLOCK_OPENCLIP = [(s, s) for s in (
    "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias", "attn.in_proj_weight",
    "attn.in_proj_bias", "attn.out_proj.weight", "attn.out_proj.bias", "mlp.c_fc.weight",
    "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")]
_BLOCK_HF = [  # (port leaf, HF leaf); in_proj is stacked from q, k, v
    ("ln_1.weight", "layer_norm1.weight"), ("ln_1.bias", "layer_norm1.bias"),
    ("ln_2.weight", "layer_norm2.weight"), ("ln_2.bias", "layer_norm2.bias"),
    ("attn.out_proj.weight", "self_attn.out_proj.weight"),
    ("attn.out_proj.bias", "self_attn.out_proj.bias"),
    ("mlp.c_fc.weight", "mlp.fc1.weight"), ("mlp.c_fc.bias", "mlp.fc1.bias"),
    ("mlp.c_proj.weight", "mlp.fc2.weight"), ("mlp.c_proj.bias", "mlp.fc2.bias")]


class _Taker:
    """Pull keys from a state dict, tracking hits so leftovers get reported."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.used: set = set()
        self.missing: List[str] = []

    def __call__(self, name: str):
        if name not in self.sd:
            self.missing.append(name)
            return None
        self.used.add(name)
        return np.asarray(self.sd[name], np.float32)


def _openclip(take, config) -> Dict[str, np.ndarray]:
    out = {f"visual.{k}": take(f"visual.{k}") for k in (
        "conv1.weight", "class_embedding", "positional_embedding", "ln_pre.weight",
        "ln_pre.bias", "ln_post.weight", "ln_post.bias", "proj")}
    for i in range(config.vision.layers):
        for dst, src in _BLOCK_OPENCLIP:
            out[f"visual.transformer.resblocks.{i}.{dst}"] = take(
                f"visual.transformer.resblocks.{i}.{src}")
    for k in ("token_embedding.weight", "positional_embedding", "ln_final.weight",
              "ln_final.bias"):
        out[f"text.{k}"] = take(k)
    for i in range(config.text.layers):
        for dst, src in _BLOCK_OPENCLIP:
            out[f"text.transformer.resblocks.{i}.{dst}"] = take(
                f"transformer.resblocks.{i}.{src}")
    out["text_projection"] = take("text_projection")      # (width, embed) as it is
    return out


def _hf_block(take, src: str, dst: str, out: Dict) -> None:
    for leaf, hf in _BLOCK_HF:
        out[f"{dst}.{leaf}"] = take(f"{src}.{hf}")
    for kind in ("weight", "bias"):
        parts = [take(f"{src}.self_attn.{p}_proj.{kind}") for p in "qkv"]
        out[f"{dst}.attn.in_proj_{kind}"] = (
            None if any(p is None for p in parts) else np.concatenate(parts, axis=0))


def _t(x):
    return None if x is None else np.ascontiguousarray(x.T)


def _hf(take, config) -> Dict[str, np.ndarray]:
    emb = "vision_model.embeddings"
    out = {"visual.conv1.weight": take(f"{emb}.patch_embedding.weight"),
           "visual.class_embedding": take(f"{emb}.class_embedding"),
           "visual.positional_embedding": take(f"{emb}.position_embedding.weight")}
    for ours, theirs in (("ln_pre", "vision_model.pre_layrnorm"),   # HF's spelling
                         ("ln_post", "vision_model.post_layernorm")):
        for kind in ("weight", "bias"):
            out[f"visual.{ours}.{kind}"] = take(f"{theirs}.{kind}")
    for i in range(config.vision.layers):
        _hf_block(take, f"vision_model.encoder.layers.{i}",
                  f"visual.transformer.resblocks.{i}", out)
    out["visual.proj"] = _t(take("visual_projection.weight"))
    out["text.token_embedding.weight"] = take("text_model.embeddings.token_embedding.weight")
    out["text.positional_embedding"] = take("text_model.embeddings.position_embedding.weight")
    for i in range(config.text.layers):
        _hf_block(take, f"text_model.encoder.layers.{i}", f"text.transformer.resblocks.{i}",
                  out)
    for kind in ("weight", "bias"):
        out[f"text.ln_final.{kind}"] = take(f"text_model.final_layer_norm.{kind}")
    out["text_projection"] = _t(take("text_projection.weight"))
    return out


def convert_clip_checkpoint(state_dict: Dict[str, np.ndarray], config,
                            allow_partial: bool = False
                            ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """state_dict (flat torch-layout arrays) + CLIPScoreConfig ->
    (the scorer's state dict in fp32 numpy, report). The report lists the
    checkpoint keys that were neither used nor known buffers, and the
    expected keys that were missing. A checkpoint missing expected keys
    raises with the missing list unless `allow_partial=True`, which leaves
    those entries out (load the result with strict=False)."""
    state_dict = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
                  for k, v in state_dict.items()}
    is_hf = any(k.startswith(("vision_model.", "text_model.")) for k in state_dict)
    take = _Taker(state_dict)
    out = _hf(take, config) if is_hf else _openclip(take, config)
    if is_hf:
        buffers = [k for k in state_dict if k.endswith("position_ids") or k == "logit_scale"]
    else:
        buffers = [k for k in state_dict if k == "logit_scale" or k.startswith("attn_mask")]
    if take.missing and not allow_partial:
        raise KeyError(
            f"checkpoint is missing {len(take.missing)} expected CLIP keys "
            f"(pass allow_partial=True to convert the keys that are there): "
            f"{take.missing[:8]}{'...' if len(take.missing) > 8 else ''}")
    report = [f"not loaded: {m}" for m in take.missing]
    report += [f"unused ckpt key: {k}" for k in state_dict
               if k not in take.used and k not in buffers]
    return {k: v for k, v in out.items() if v is not None}, report
