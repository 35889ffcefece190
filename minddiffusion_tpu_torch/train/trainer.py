"""Latent-diffusion training: the loss, the train state and the train step
(port of minddiffusion_tpu/train/trainer.py).

  * `diffusion_loss`: t ~ U[0, T), z0 = 0.18215 * a VAE posterior sample
    under no_grad (the first stage is frozen), or a pre-encoded latent;
    optional CFG text dropout (the context zeroed for a random subset);
    eps-MSE. Its draws come from a torch.Generator, or explicitly: `draws`
    may hold "t" (B,), "noise" and "enc_noise" (B, h, w, 4) and "keep" (B,)
    (1 keeps the context), so a test can feed it the JAX package's draws.
  * `make_train_step`: DreamBooth's paired loss (train + prior_loss_weight *
    reg), the gradient of every UNet and text-encoder parameter (the JAX step
    differentiates all params: `grad_norm` is the global norm over all of
    them, the frozen text encoder's included, the VAE's being zero), the
    finite guard, and one AdamW update of the trainable ones
    (train/optim.AdamW, which keeps the state where a gradient is not
    finite). The metrics stay on the device: the loop fetches them at its
    log and checkpoint boundaries, not every step.

The step's generator is seeded from (seed, step), as the JAX step folds the
step into its key, so a step's draws do not depend on the steps before it.

On a process grid (`create_train_state(..., mesh=)`, parallel/mesh.py) each
rank takes its rows of the global batch. It draws the global batch's draws
and keeps its rows (`Rows`), so a step on the grid is the one-process step
on the global batch up to the order of its sums, as the JAX package's
sharded step is. The gradient is averaged over the data ranks, or sharded
by FSDP2 under fsdp > 1 (parallel/collectives.gradients); the loss metrics
are their means over the data ranks, and the finite guard, `grad_norm` and
the clip read the whole gradient. Under tp > 1 the networks compute on
their tp pieces (parallel/tensor_parallel.py), every tp rank of a data
rank takes the same rows and draws, the fused AdamW steps each rank's
pieces, and `grad_norm` sums a piece's squares over the tp ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from minddiffusion_tpu_torch.core import distributions, latents
from minddiffusion_tpu_torch.io.sd_weights import PREFIXES
from minddiffusion_tpu_torch.parallel.collectives import (global_norm, global_rows,
                                                           gradients, mean_over_ranks)
from minddiffusion_tpu_torch.parallel.mesh import (Rows, batch_sharding, data_group,
                                                   shard_params)
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels
from minddiffusion_tpu_torch.train.lr_schedules import warmup_then_decay
from minddiffusion_tpu_torch.train.optim import AdamW, named_parameters


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror configs/train_config.json (betas .9/.98, lr 1e-5 ->
    1e-7, warmup 1000, wd 1e-6 on the decay set)."""

    start_lr: float = 1e-5
    end_lr: float = 1e-7
    warmup_steps: int = 1000
    decay_steps: int = 100_000
    use_cosine: bool = True
    beta1: float = 0.9
    beta2: float = 0.98
    weight_decay: float = 1e-6
    max_grad_norm: float = 1.0
    trainable: str = "unet"
    cond_dropout: float = 0.0
    prior_loss_weight: float = 1.0


@dataclasses.dataclass
class TrainState:
    """The models (their parameters are the train params), the optimizer
    state, `step`, the steps taken so far (a host count: it advances on a
    non-finite step too, as the JAX step's does), the process grid (None:
    one process) and its tp record (parallel/tensor_parallel.TensorParallel,
    its pieces by LDM name; None under tp 1)."""

    models: SDModels
    optimizer: AdamW
    step: int = 0
    mesh: object = None
    tp: object = None

    @property
    def grad_params(self) -> Dict[str, torch.nn.Parameter]:
        """The params the step differentiates: the UNet's and the text
        encoder's (the VAE runs under no_grad)."""
        return named_parameters({"unet": self.models.unet, "text": self.models.text_encoder})


def create_train_state(models: SDModels, config: TrainConfig, mesh=None) -> TrainState:
    """Turn on grad for the UNet and text encoder, off for the VAE, place
    the networks on `mesh` (parallel/mesh.shard_params: tp pieces under tp
    > 1, FSDP2 under fsdp > 1), and build the optimizer over the trainable
    set."""
    for kind, module in models.modules().items():
        module.requires_grad_(kind != "vae")
    tp = shard_params(models.modules(), mesh, PREFIXES) if mesh is not None else None
    lr = warmup_then_decay(config.start_lr, config.end_lr, config.warmup_steps,
                           config.decay_steps, use_cosine=config.use_cosine)
    opt = AdamW(named_parameters(models.modules()), lr, weight_decay=config.weight_decay,
                beta1=config.beta1, beta2=config.beta2, max_grad_norm=config.max_grad_norm,
                trainable=config.trainable, tp=tp)
    return TrainState(models=models, optimizer=opt, mesh=mesh, tp=tp)


def diffusion_loss(models: SDModels, images: Optional[torch.Tensor], tokens: torch.Tensor,
                   generator: Optional[torch.Generator], cond_dropout: float = 0.0,
                   latent: Optional[torch.Tensor] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   rows: Rows = Rows()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """eps-MSE loss (ddpm.py p_losses 'l_simple'). `images` (B, H, W, 3) in
    [-1, 1], or `latent` (B, h, w, 4) already scaled; `tokens` (B, L).
    `rows`: the batch is this rank's rows of a global batch; every draw,
    explicit or from `generator`, is the global batch's, cut to them."""
    draws = draws or {}
    dev = models.device

    def draw(key, fn, shape, **kw):
        if key in draws:
            return rows.take(draws[key], key).to(dev)
        return global_rows(fn, rows, shape, generator=generator, device=dev, **kw)

    if latent is not None:
        z0 = latent.to(dev).float()
    else:
        with torch.no_grad():
            moments = models.vae.encode(images.to(dev))
            mean = distributions.split_moments(moments)[0]
            eps = draw("enc_noise", torch.randn, mean.shape, dtype=mean.dtype)
            z0 = latents.scale_latents(distributions.sample(moments, eps=eps),
                                       models.scale_factor)
    b = z0.shape[0]
    ctx = models.text_encoder(tokens.to(dev))
    if cond_dropout > 0.0:
        keep = (rows.take(draws["keep"], "keep") if "keep" in draws
                else draw("keep", torch.rand, (b,)) < 1.0 - cond_dropout)
        ctx = ctx * keep.to(dev, ctx.dtype)[:, None, None]
    t = draw("t", lambda shape, **kw: torch.randint(0, models.schedule.num_timesteps,
                                                     shape, **kw), (b,)).long()
    noise = draw("noise", torch.randn, z0.shape).float()
    x_t = models.schedule.q_sample(z0, t, noise)
    eps_hat = models.unet(x_t, t, ctx)
    mse = torch.mean(torch.square(eps_hat.float() - noise), dim=(1, 2, 3))
    loss = torch.mean(mse)
    return loss, {"loss": loss, "mse_t_mean": torch.mean(t.float())}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def make_loss_and_grads(config: TrainConfig, dreambooth: bool = False) -> Callable:
    """fn(state, batch, generator, draws=None) -> (metrics, grads): the loss
    of one batch and the gradient of every `state.grad_params` entry
    (parallel/collectives.gradients: zeros where the loss does not reach a
    param, averaged over the data ranks on a grid, where the metrics are
    their means over the ranks too). `draws` (dreambooth: a pair, train
    then reg) replace the generator's draws; on a grid they are the global
    batch's, as the generator's are."""

    def fn(state: TrainState, batch: Dict[str, torch.Tensor],
           generator: Optional[torch.Generator], draws=None):
        models = state.models
        rows = batch_sharding(state.mesh)
        d_train, d_reg = draws if dreambooth and draws is not None else (draws, None)
        loss, metrics = diffusion_loss(
            models, batch.get("image"), batch["tokens"], generator,
            cond_dropout=config.cond_dropout, latent=batch.get("latent"), draws=d_train,
            rows=rows)
        if dreambooth:
            reg_loss, _ = diffusion_loss(
                models, batch.get("reg_image"), batch["reg_tokens"], generator,
                latent=batch.get("reg_latent"), draws=d_reg, rows=rows)
            metrics["train_loss"] = loss
            metrics["reg_loss"] = reg_loss
            loss = loss + config.prior_loss_weight * reg_loss
            metrics["loss"] = loss
        grads = gradients(loss, lambda: state.grad_params, set(state.optimizer.trainable),
                          state.mesh)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (metrics if state.mesh is None else
                mean_over_ranks(metrics, data_group(state.mesh))), grads

    return fn


def make_train_step(config: TrainConfig, dreambooth: bool = False) -> Callable:
    """step(state, batch, seed, draws=None) -> metrics (0-d device tensors:
    loss, mse_t_mean, grads_finite, grad_norm; dreambooth adds train_loss and
    reg_loss). Updates `state` in place.

    batch: {"image" (B, H, W, 3) fp32, "tokens" (B, L)} or {"latent",
    "tokens"}, plus {"reg_image" / "reg_latent", "reg_tokens"} when
    `dreambooth` (loss = loss_train + prior_loss_weight * loss_reg); on a
    grid, this rank's rows of the global batch (parallel/mesh.shard_batch)."""
    loss_and_grads = make_loss_and_grads(config, dreambooth)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             draws=None) -> Dict[str, torch.Tensor]:
        gen = step_generator(seed, state.step, state.models.device)
        metrics, grads = loss_and_grads(state, batch, gen, draws)
        g_norm = global_norm(list(grads.values()), state.tp, list(grads))
        finite = torch.isfinite(g_norm)
        metrics["grads_finite"] = finite.to(torch.float32)
        metrics["grad_norm"] = torch.where(finite, g_norm, 0.0)
        state.optimizer.step(grads, finite)
        state.step += 1
        return metrics

    return step
