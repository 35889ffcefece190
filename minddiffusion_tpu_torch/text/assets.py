"""Vocabulary asset resolution (the port's copy of minddiffusion_tpu/text/assets.py).

Tokenizer logic lives in this package; the vocabulary data files are public
assets that ship with SD checkpoints. Resolution order: explicit path
argument > the MINDDIFFUSION_TPU_ASSETS directory > `assets/` at the root of
this repository. The port reads no path outside its own checkout.
"""
from __future__ import annotations

import os
from pathlib import Path

_REPO_ASSETS = Path(__file__).resolve().parents[2] / "assets"


def resolve_asset(name: str, explicit: str | None = None) -> str:
    if explicit:
        if not os.path.exists(explicit):
            raise FileNotFoundError(explicit)
        return explicit
    for directory in (os.environ.get("MINDDIFFUSION_TPU_ASSETS"), _REPO_ASSETS):
        if directory:
            p = Path(directory) / name
            if p.exists():
                return str(p)
    raise FileNotFoundError(
        f"tokenizer asset {name!r} not found; pass an explicit path, set "
        f"MINDDIFFUSION_TPU_ASSETS to a directory containing it, or put it in "
        f"{_REPO_ASSETS}")
