"""DreamBooth paired dataset: instance (train) images + class (reg) images
(port of minddiffusion_tpu/data/dataset_db.py).

Reference behavior (wukong-huahua/ldm/data/dataset_db.py:31-101 +
t2i_collate.py:32-46): train images repeated `train_data_repeats` times so
both streams have comparable length; captions synthesized as
"<token> <class_word>" for instance images and "<class_word>" for
regularization images; each batch carries all four fields.

The JAX package does not shard this stream by host, and neither does the
port: every node reads all of it, and each of a node's ranks keeps its rows
of every batch (`row_index` of `row_count`, by default its place on the
process group; data/dataset.py).
"""
from __future__ import annotations

import os
import random
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from minddiffusion_tpu_torch.data import transforms
from minddiffusion_tpu_torch.data.dataset import placement


def _list_images(path: str) -> List[str]:
    exts = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in exts
    )


class DreamBoothDataset:
    def __init__(
        self,
        instance_data_dir: str,
        class_data_dir: str,
        token: str,
        class_word: str,
        tokenize: Callable[[List[str]], np.ndarray],
        batch_size: int = 1,
        image_size: int = 512,
        train_data_repeats: int = 100,
        seed: int = 0,
        flip_p: float = 0.5,
        row_index: Optional[int] = None,
        row_count: Optional[int] = None,
    ):
        _, self.rows = placement(batch_size, row_index=row_index, row_count=row_count)
        self.instance_images = _list_images(instance_data_dir) * train_data_repeats
        self.class_images = _list_images(class_data_dir)
        if not self.instance_images or not self.class_images:
            raise ValueError("both instance and class image dirs must be non-empty")
        self.instance_prompt = f"{token} {class_word}"
        self.class_prompt = class_word
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.flip_p = flip_p

    def __len__(self) -> int:
        return len(self.instance_images) // self.batch_size

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch_index)
        order = list(range(len(self.instance_images)))
        rng.shuffle(order)
        inst_toks = self.tokenize([self.instance_prompt] * self.batch_size)
        reg_toks = self.tokenize([self.class_prompt] * self.batch_size)
        batch_imgs, batch_regs = [], []
        for idx in order:
            img = transforms.preprocess_image(
                self.instance_images[idx], self.image_size, False, self.flip_p, rng)
            reg_path = self.class_images[rng.randrange(len(self.class_images))]
            reg = transforms.preprocess_image(
                reg_path, self.image_size, False, self.flip_p, rng)
            batch_imgs.append(img)
            batch_regs.append(reg)
            if len(batch_imgs) == self.batch_size:
                batch = {
                    "image": np.stack(batch_imgs),
                    "tokens": np.asarray(inst_toks, np.int32),
                    "reg_image": np.stack(batch_regs),
                    "reg_tokens": np.asarray(reg_toks, np.int32),
                }
                yield {k: self.rows.take(v, k) for k, v in batch.items()}
                batch_imgs, batch_regs = [], []
