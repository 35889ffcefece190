"""GLIDE training data: a manifest of TSV manifests -> numpy batches of
(image, tokens, mask, t, weights[, low_res]) (port of
minddiffusion_tpu/data/glide_dataset.py; reference Taichu-GLIDE
train/image_datasets.py).

  * `read_manifests`: a text file listing TSV manifests; each TSV row holds
    an image path, relative to its TSV, and a caption;
  * per epoch, random.Random(seed + epoch) shuffles the pairs, randomly
    crops each image and drops its text with probability `text_drop_p`
    (the tokens of "", the CFG uncond branch), and np.random.RandomState(seed + epoch) draws
    each batch's (t, w) with the uniform sampler: the JAX package's draws in
    its order, so the batches are equal bit for bit;
  * the super-res variant adds `low_res`, the crop box-averaged down to
    `super_res_size`;
  * an unreadable image (OSError) is skipped;
  * the pairs are sharded by node, pairs[shard_index::shard_count], as the
    JAX package shards them by host, and each of a node's ranks keeps its
    rows (t and weights with them) of every node batch (data/dataset.py).
"""
from __future__ import annotations

import os
import random
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from minddiffusion_tpu_torch.data import transforms
from minddiffusion_tpu_torch.data.dataset import placement
from minddiffusion_tpu_torch.train.resample import UniformSampler


def read_manifests(image_caption_path_file: str) -> List[Tuple[str, str]]:
    """-> list of (image_path, caption)."""
    with open(image_caption_path_file) as f:
        manifest_paths = [line.strip() for line in f if line.strip()]
    pairs: List[Tuple[str, str]] = []
    for mp in manifest_paths:
        base = os.path.dirname(mp)
        with open(mp) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    pairs.append((os.path.join(base, parts[0]), parts[1]))
    return pairs


class GlideTextImageDataset:
    """The base (or, with `super_res_size`, the super-res) training stream."""

    def __init__(self, pairs: List[Tuple[str, str]],
                 encode_and_pad: Callable[[str], Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, image_size: int = 64, num_timesteps: int = 1000,
                 text_drop_p: float = 0.2, seed: int = 0,
                 super_res_size: Optional[int] = None, shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None, row_index: Optional[int] = None,
                 row_count: Optional[int] = None):
        shard, self.rows = placement(batch_size, shard_index, shard_count, row_index,
                                     row_count)
        self.pairs = pairs[shard]
        self.encode_and_pad = encode_and_pad
        self.batch_size = batch_size
        self.image_size = image_size
        self.text_drop_p = text_drop_p
        self.empty = encode_and_pad("")
        self.seed = seed
        self.sampler = UniformSampler(num_timesteps)
        self.super_res_size = super_res_size

    def __len__(self) -> int:
        return len(self.pairs) // self.batch_size

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch_index)
        nprng = np.random.RandomState(self.seed + epoch_index)
        order = list(range(len(self.pairs)))
        rng.shuffle(order)
        imgs, toks, masks, lows = [], [], [], []
        for idx in order:
            path, caption = self.pairs[idx]
            try:
                img = transforms.preprocess_image(path, self.image_size, True, flip_p=0.0,
                                                  rng=rng)
            except OSError:
                continue
            tok, mask = (self.empty if rng.random() < self.text_drop_p
                         else self.encode_and_pad(caption))
            imgs.append(img)
            toks.append(np.asarray(tok, np.int32))
            masks.append(np.asarray(mask, np.int32))
            if self.super_res_size is not None:
                s = self.super_res_size
                f = self.image_size // s
                lows.append(img.reshape(s, f, s, f, 3).mean(axis=(1, 3)))
            if len(imgs) == self.batch_size:
                t, w = self.sampler.sample_np(nprng, self.batch_size)
                batch = {"image": np.stack(imgs), "tokens": np.stack(toks),
                         "mask": np.stack(masks), "t": t, "weights": w}
                if lows:
                    batch["low_res"] = np.stack(lows).astype(np.float32)
                yield {k: self.rows.take(v, k) for k, v in batch.items()}
                imgs, toks, masks, lows = [], [], [], []
