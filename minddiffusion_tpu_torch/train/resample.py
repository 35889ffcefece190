"""Timestep schedule samplers (port of minddiffusion_tpu/train/resample.py;
reference Taichu-GLIDE train/resample.py:34-76).

`UniformSampler.sample` draws on the device from a torch.Generator;
`sample_np` and the loss-aware `LossSecondMomentResampler` are host-side
numpy with the JAX package's arithmetic and draw order, so the same
RandomState gives the same (t, w) bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class UniformSampler:
    """t ~ U[0, T); w = 1."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, w) on `device`, by default the generator's: a CUDA generator
        draws on the card. Without a generator the device must be given."""
        if device is None:
            if generator is None:
                raise ValueError("UniformSampler.sample needs a generator or a device")
            device = generator.device
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator,
                          device=device)
        return t, torch.ones((batch,), dtype=torch.float32, device=device)

    def sample_np(self, rng: np.random.RandomState, batch: int):
        t = rng.randint(0, self.num_timesteps, size=(batch,))
        return t.astype(np.int32), np.ones((batch,), np.float32)


class LossSecondMomentResampler:
    """Importance-sample t proportional to sqrt(E[loss^2]), with uniform
    sampling until every timestep holds `history_per_term` losses."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 1e-3):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())

    def weights_np(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64) / self.num_timesteps
        w = np.sqrt(np.mean(self._history ** 2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def sample_np(self, rng: np.random.RandomState, batch: int):
        p = self.weights_np()
        t = rng.choice(self.num_timesteps, size=(batch,), p=p)
        weights = 1.0 / (self.num_timesteps * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update(self, ts: np.ndarray, losses: np.ndarray) -> None:
        """Record one loss per sampled timestep (host arrays)."""
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            c = self._counts[t]
            if c == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, c] = loss
                self._counts[t] += 1
