"""Host-side image preprocessing, PIL + numpy (the port's copy of
minddiffusion_tpu/data/transforms.py): resize the shorter edge ->
(center | random) crop to image_size -> optional horizontal flip ->
[-1, 1] (wukong-huahua/ldm/data/dataset.py:146-190)."""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image


def load_rgb(path: str) -> Image.Image:
    img = Image.open(path)
    return img.convert("RGB") if img.mode != "RGB" else img


def resize_shorter_edge(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    scale = size / min(w, h)
    return img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                      Image.BICUBIC)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


def random_crop(arr: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    h, w = arr.shape[:2]
    top = rng.randint(0, h - size) if h > size else 0
    left = rng.randint(0, w - size) if w > size else 0
    return arr[top:top + size, left:left + size]


def preprocess_image(path: str, image_size: int, use_random_crop: bool = False,
                     flip_p: float = 0.5, rng: Optional[random.Random] = None) -> np.ndarray:
    """-> (H, W, 3) fp32 in [-1, 1]."""
    rng = rng or random
    img = resize_shorter_edge(load_rgb(path), image_size)
    arr = np.asarray(img, dtype=np.uint8)
    arr = (random_crop(arr, image_size, rng) if use_random_crop
           else center_crop(arr, image_size))
    if flip_p > 0 and rng.random() < flip_p:
        arr = arr[:, ::-1]
    return (arr.astype(np.float32) / 127.5) - 1.0


def image_dims(path: str) -> Tuple[int, int]:
    with Image.open(path) as im:
        return im.size  # (w, h)
