"""Text-image training data: CSV manifests -> prefetched numpy batches
(port of minddiffusion_tpu/data/dataset.py).

`data_path` holds images plus `*.csv` manifests with `dir` (image path
relative to data_path) and `text` (caption) columns; images whose short side
is below `image_filter_size` are dropped; each sample is (image fp32 in
[-1, 1], tokens int32). The JAX package reads the manifests with pandas;
this port reads them with the csv module and reproduces pandas' result for
the captions it reads as missing: an empty field (or another of pandas'
default NA strings) becomes the caption "nan", as `str(NaN)` does there.

The list is sharded by node as the JAX package shards it by host: node
`shard_index` of `shard_count` reads images[shard_index::shard_count]. Each
of a node's ranks walks the node's epoch order and keeps its rows (block
`row_index` of `row_count`) of every batch of `batch_size`, so
`batch_size` is the batch of one node, as it is the batch of one host in
JAX, and a node's ranks together train on the batches the JAX loader gives
its host. All four default to this process's place on the process group
(parallel/mesh.data_layout: node 0 of 1 and the whole batch without one).
A background thread prefetches PREFETCH batches ahead of the training step.
"""
from __future__ import annotations

import csv
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from minddiffusion_tpu_torch.data import transforms
from minddiffusion_tpu_torch.parallel.mesh import Rows, data_layout

# pandas.read_csv's default NA strings (pandas/_libs/parsers.pyx STR_NA_VALUES)
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


PREFETCH = 2


def _cell(value: str) -> str:
    return "nan" if value in PANDAS_NA else value


def list_image_files_captions(data_path: str) -> Tuple[List[str], List[str]]:
    csvs = sorted(os.path.join(data_path, f) for f in os.listdir(data_path)
                  if f.endswith(".csv"))
    if not csvs:
        raise ValueError(f"no .csv manifests under {data_path}")
    images, captions = [], []
    for path in csvs:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                images.append(os.path.join(data_path, _cell(row["dir"])))
                captions.append(_cell(row["text"]))
    return images, captions


def filter_small_images(images: List[str], captions: List[str], min_size: int,
                        workers: int = 32, cache_dir: Optional[str] = None,
                        ) -> Tuple[List[str], List[str]]:
    """Drop images whose short side is < min_size (unreadable ones too).
    Header reads run on a thread pool; the keep-mask is memoized to a
    sidecar `.filter_cache_<min_size>_<rows>.npy` in `cache_dir`."""
    cache_path = None
    if cache_dir is not None:
        cache_path = os.path.join(cache_dir, f".filter_cache_{min_size}_{len(images)}.npy")
        if os.path.exists(cache_path):
            keep = np.load(cache_path)
            if keep.shape[0] == len(images):
                return ([im for im, k in zip(images, keep) if k],
                        [c for c, k in zip(captions, keep) if k])

    def check(img: str) -> bool:
        try:
            w, h = transforms.image_dims(img)
        except OSError:
            return False
        return min(w, h) >= min_size

    with ThreadPoolExecutor(max_workers=workers) as pool:
        keep = list(pool.map(check, images, chunksize=256))
    if cache_path is not None:
        try:
            np.save(cache_path, np.asarray(keep, bool))
        except OSError:
            pass
    return ([im for im, k in zip(images, keep) if k],
            [c for c, k in zip(captions, keep) if k])


class TextImageDataset:
    """Iterable over epochs of {image, tokens} batches: this rank's rows of
    its node's batches."""

    def __init__(self, images: List[str], captions: List[str],
                 tokenize: Callable[[List[str]], np.ndarray], batch_size: int,
                 image_size: int = 512, random_crop: bool = False, flip_p: float = 0.5,
                 seed: int = 0, shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None, row_index: Optional[int] = None,
                 row_count: Optional[int] = None):
        shard, self.rows = placement(batch_size, shard_index, shard_count, row_index,
                                     row_count)
        self.images = images[shard]
        self.captions = captions[shard]
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.image_size = image_size
        self.random_crop = random_crop
        self.flip_p = flip_p
        self.seed = seed

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def _load_one(self, idx: int, rng: random.Random) -> Optional[np.ndarray]:
        try:
            return transforms.preprocess_image(self.images[idx], self.image_size,
                                               self.random_crop, self.flip_p, rng)
        except OSError:
            return None  # unreadable image: skipped

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch_index)
        order = list(range(len(self.images)))
        rng.shuffle(order)

        def produce(out_q: queue.Queue):
            batch_imgs, batch_caps = [], []
            for idx in order:
                img = self._load_one(idx, rng)
                if img is None:
                    continue
                batch_imgs.append(img)
                batch_caps.append(self.captions[idx])
                if len(batch_imgs) == self.batch_size:
                    out_q.put({"image": self.rows.take(np.stack(batch_imgs)),
                               "tokens": self.rows.take(
                                   np.asarray(self.tokenize(batch_caps), np.int32))})
                    batch_imgs, batch_caps = [], []
            out_q.put(None)

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        threading.Thread(target=produce, args=(q,), daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item


def placement(batch_size: int, shard_index: Optional[int] = None,
              shard_count: Optional[int] = None, row_index: Optional[int] = None,
              row_count: Optional[int] = None) -> Tuple[slice, Rows]:
    """(this node's slice of the list, this rank's rows of a node batch),
    each part not given taken from the process group (`data_layout`).
    Refuses a batch that does not divide over the node's ranks, as JAX's
    device_put refuses one that does not divide over the devices."""
    node, nodes, row, rows = data_layout()
    pick = (lambda value, default: default if value is None else value)
    rows = Rows(pick(row_index, row), pick(row_count, rows))
    if batch_size % rows.count:
        raise ValueError(f"batch size {batch_size} does not divide over the node's "
                         f"{rows.count} ranks")
    return slice(pick(shard_index, node), None, pick(shard_count, nodes)), rows


def load_data(data_path: str, batch_size: int, tokenize: Callable, image_size: int = 512,
              image_filter_size: int = 256, random_crop: bool = False,
              filter_small_size: bool = True, seed: int = 0, **shards) -> TextImageDataset:
    """The reference's load_data surface (dataset.py:31-74); `shards`:
    TextImageDataset's shard_index, shard_count, row_index, row_count."""
    images, captions = list_image_files_captions(data_path)
    if filter_small_size:
        images, captions = filter_small_images(images, captions, image_filter_size,
                                               cache_dir=data_path)
    if not images:
        raise ValueError("no usable images after filtering")
    return TextImageDataset(images, captions, tokenize, batch_size, image_size=image_size,
                            random_crop=random_crop, seed=seed, **shards)
