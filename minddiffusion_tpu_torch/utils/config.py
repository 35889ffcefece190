"""CLI flags with a JSON overlay and YAML model configs (the port's copy of
minddiffusion_tpu/utils/config.py).

A JSON value fills every flag the user did not pass explicitly on the
command line (stablediffusionv2/ldm/modules/train/tools.py:38-49). A YAML
model config names a `target:` callable by its dotted path and its
`params:`, which `instantiate_from_config` calls (ldm/util.py:37-52); the
port's own configs are in minddiffusion_tpu_torch/configs/.
"""
from __future__ import annotations

import argparse
import importlib
import json
import random
import sys
from typing import Any

import numpy as np
import torch


def parse_with_config(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse args; if --config names a JSON file, its values set every flag
    not present on the command line."""
    args = parser.parse_args(argv)
    config_path = getattr(args, "config", None)
    if config_path:
        with open(config_path) as f:
            data = json.load(f)
        argv = sys.argv[1:] if argv is None else argv
        given = {a.split("=")[0].lstrip("-").replace("-", "_")
                 for a in argv if a.startswith("-")}
        for k, v in data.items():
            if k not in given and hasattr(args, k):
                setattr(args, k, v)
    return args


def get_obj_from_str(path: str) -> Any:
    """The object a dotted path "pkg.module.name" names."""
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: dict) -> Any:
    """{"target": "pkg.mod.fn", "params": {...}} -> fn(**params)."""
    if "target" not in config:
        raise KeyError(f"config has no target: {config}")
    return get_obj_from_str(config["target"])(**config.get("params", {}))


def load_yaml(path: str) -> dict:
    """The YAML file at `path` as a dict (PyYAML, imported here: nothing
    else of the port reads YAML)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs (Python, numpy) and torch's default generators;
    the train step draws from its own seeded generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
