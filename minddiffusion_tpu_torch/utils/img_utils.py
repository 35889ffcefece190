"""Image grid and save helpers on the host (port of
minddiffusion_tpu/utils/img_utils.py; numpy and PIL, torch tensors taken
as their host arrays)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def to_uint8(x) -> np.ndarray:
    """fp32 [-1, 1] (B, H, W, 3) -> uint8."""
    x = np.clip((_host(x) + 1.0) * 127.5, 0, 255)
    return np.round(x).astype(np.uint8)


def make_grid(images, cols: Optional[int] = None) -> np.ndarray:
    """(B, H, W, 3) uint8 -> one (rows * H, cols * W, 3) grid image."""
    images = _host(images)
    b, h, w, c = images.shape
    cols = cols or int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i in range(b):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return grid


def save_image_grid(images, path: str, cols: Optional[int] = None) -> str:
    from PIL import Image

    arr = _host(images)
    arr = arr if arr.dtype == np.uint8 else to_uint8(arr)
    Image.fromarray(make_grid(arr, cols)).save(path)
    return path
