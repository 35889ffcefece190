"""Seeded weights of a configuration, made on the device in a few large
calls, as one flat LDM-named state dict that both the program and the
reference are given.

Scales (those of the program's own seeded init, at which its activations
stay in range): matrices and conv kernels N(0, 1/fan_in), biases
N(0, 0.02^2), norm scales 1 + N(0, 0.05^2) and shifts N(0, 0.05^2), the
token embedding N(0, 0.02^2), the positional embedding N(0, 0.01^2).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.layout import model_params

STD = {"b": 0.02, "norm_w": 0.05, "norm_b": 0.05, "emb": 0.02, "pos": 0.01}
CHUNK = 1 << 28        # elements drawn in one call


def make(config: dict, seed: int, device, dtype: torch.dtype
         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(state dict of views into one flat buffer, the buffer) in `dtype`."""
    params = list(model_params(config))
    numel = [math.prod(shape) for _, shape, _ in params]
    std = [STD.get(kind) or math.prod(shape[1:]) ** -0.5 for _, shape, kind in params]
    mean = [1.0 if kind == "norm_w" else 0.0 for _, _, kind in params]
    flat = torch.empty(sum(numel), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    start = i = 0
    while i < len(params):
        j, n = i, 0
        while j < len(params) and (n == 0 or n + numel[j] <= CHUNK):
            n += numel[j]
            j += 1
        counts = torch.tensor(numel[i:j], device=device)
        scale = torch.repeat_interleave(torch.tensor(std[i:j], device=device), counts)
        shift = torch.repeat_interleave(torch.tensor(mean[i:j], device=device), counts)
        draw = torch.randn(n, generator=gen, device=device)
        flat[start:start + n] = (draw * scale + shift).to(dtype)
        start, i = start + n, j
    out, off = {}, 0
    for (name, shape, _), n in zip(params, numel):
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out, flat
