"""CLI flags with a JSON overlay (the port's copy of
minddiffusion_tpu/utils/config.py `parse_with_config`, `set_random_seed`).

A JSON value fills every flag the user did not pass explicitly on the
command line (stablediffusionv2/ldm/modules/train/tools.py:38-49).
"""
from __future__ import annotations

import argparse
import json
import random
import sys

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


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs (Python, numpy) and torch's default generators;
    the train step draws from its own seeded generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
