"""The JAX package's GLIDE params (a flax tree of numpy arrays) as the port's
state dicts.

    sd = state_dict_from_jax({"base": {"params": ...},
                              "super_res": {"params": ...},
                              "srgan": {"params": ..., "batch_stats": ...}})
    models.load_state_dict(sd)          # pipelines/glide_cascade.GlideModels

The port's GLIDE modules carry the flax names, so the map is mechanical:
the flax path joined with "."; GroupNorm_0 / LayerNorm_0 levels dropped
and their `scale` renamed `weight`; inside a ResBlock the flax names go to
the port's LDM names (norm_in -> in_layers.0, conv_in -> in_layers.2,
emb_proj -> emb_layers.1, norm_out -> out_layers.0, conv_out ->
out_layers.3, skip -> skip_connection); dense kernels (in, out) are
transposed to (out, in) and conv kernels HWIO to OIHW. The SRGAN's
BatchNorm keeps `scale` / `bias` and takes `mean` / `var` from
`batch_stats`. Nothing here imports JAX.

Training checkpoints: `train_checkpoint_from_jax` carries the JAX GLIDE
CLI's {"params", "ema"} (two trees of one model) through the same map, and
`stage_state_dict` keys either tree of a checkpoint of the port's
`cli/glide_train.py` with the stage prefix GlideModels loads:

    models.load_state_dict({**models.state_dict(),
                            **stage_state_dict(ckpt["ema"], "base")})
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np

RESBLOCK_NAMES = {"norm_in": "in_layers.0", "conv_in": "in_layers.2",
                  "emb_proj": "emb_layers.1", "norm_out": "out_layers.0",
                  "conv_out": "out_layers.3", "skip": "skip_connection"}
NORM_LEVELS = ("GroupNorm_0", "LayerNorm_0")
STAGES = ("base", "super_res", "srgan")


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _port_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    norm = any(p in NORM_LEVELS for p in path)
    parts = [RESBLOCK_NAMES.get(p, p) for p in path if p not in NORM_LEVELS]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
    elif parts[-1] == "scale" and norm:
        parts[-1] = "weight"
    return ".".join(parts), np.ascontiguousarray(value, dtype=np.float32)


def variables_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """One stage's flax variables ({"params": ...} and, for the SRGAN,
    {"batch_stats": ...}) -> the port's state dict of that module."""
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name, arr = _port_leaf(path, value)
            if name in out:
                raise KeyError(f"two flax leaves map to {name!r}")
            out[name] = arr
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """The cascade's flax variables ({"base", "super_res", "srgan"}) -> one
    flat state dict with the stage as prefix ("base.unet.in_conv.weight")."""
    unknown = set(params) - set(STAGES)
    if unknown:
        raise KeyError(f"unknown GLIDE stages {sorted(unknown)}; expected {STAGES}")
    return {f"{stage}.{k}": v for stage in STAGES if stage in params
            for k, v in variables_to_state_dict(params[stage]).items()}


def train_checkpoint_from_jax(checkpoint: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX GLIDE CLI's {"params": variables, "ema": variables} of one
    model -> {"params": state dict, "ema": state dict} in the port's names
    (what the port's glide_train saves)."""
    return {k: variables_to_state_dict(checkpoint[k]) for k in ("params", "ema")}


def stage_state_dict(tree: Mapping, stage: str) -> Dict:
    """One tree ("ema" or "params") of a glide_train checkpoint keyed with
    the cascade's stage prefix ("base" or "super_res")."""
    if stage not in STAGES[:2]:
        raise KeyError(f"a glide_train checkpoint holds a diffusion stage, not {stage!r}")
    return {f"{stage}.{k}": v for k, v in tree.items()}
