"""Faults planted under the timed path, to show that the comparison fails
them (tests/test_portbench_control.py on the CPU; `calibrate.py --fault`
on the card, for a training cell's upper readings). Each is a context
manager that patches the program and restores it.

    unchanged_step   the train step's optimizer returns the state unchanged
    half_batch       the train loss taken over the first half of the batch
    unchanged_ddim   DDIM steps that return the latent unchanged
    unchanged_dpm    DPM-Solver steps that return the latent unchanged
    half_unet        the UNet's output for the second half of a batch is the first half's
    altered_image    every served uint8 image inverted where it is quantized
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(owner, name: str, value):
    real = getattr(owner, name)
    setattr(owner, name, value(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def unchanged_step():
    from minddiffusion_tpu_torch.train.optim import AdamW

    return _patch(AdamW, "step", lambda real: lambda self, grads, finite=None: torch.zeros(()))


def half_batch():
    from minddiffusion_tpu_torch.train import trainer

    def wrap(real):
        def loss(models, images, tokens, generator, cond_dropout=0.0, latent=None,
                 draws=None, rows=trainer.Rows()):
            h = tokens.shape[0] // 2
            draws = {k: v[:h] for k, v in (draws or {}).items()}
            return real(models, images[:h], tokens[:h], generator, cond_dropout,
                        None if latent is None else latent[:h], draws, rows)
        return loss
    return _patch(trainer, "diffusion_loss", wrap)


def unchanged_ddim():
    from minddiffusion_tpu_torch.samplers import ddim

    def wrap(real):
        def tables(*a, **kw):
            t = real(*a, **kw)
            return dict(t, alpha_prev=t["alpha"].copy())      # x_{t-1} = x_t
        return tables
    return _patch(ddim, "build_tables", wrap)


def unchanged_dpm():
    from minddiffusion_tpu_torch.samplers import dpm_solver

    def wrap(real):
        def tables(*a, **kw):
            t = real(*a, **kw)
            zero = {k: t[k] * 0 for k in ("c0", "cd1", "cd2", "o3")}
            return dict(t, ratio=t["ratio"] * 0 + 1, **zero)      # x_{i+1} = x_i
        return tables
    return _patch(dpm_solver, "build_tables", wrap)


def half_unet():
    from minddiffusion_tpu_torch.models.unet import UNetModel

    def wrap(real):
        def forward(self, x, *a, **kw):
            out = real(self, x, *a, **kw)
            half = out.shape[0] // 2
            return torch.cat([out[:half], out[:half]]) if half else out
        return forward
    return _patch(UNetModel, "forward", wrap)


def altered_image():
    from minddiffusion_tpu_torch.core import latents

    return _patch(latents, "unit_range_to_uint8", lambda real: lambda x: 255 - real(x))


FAULTS = {f.__name__: f for f in (unchanged_step, half_batch, unchanged_ddim, unchanged_dpm,
                                  half_unet, altered_image)}
