"""GLIDE finetuning CLI of the PyTorch port: the flags of minddiffusion_tpu's
glide_train CLI (Taichu-GLIDE src/train_txt2img.py: TSV manifests, text
dropout for CFG, per-sample (t, w), the VLB + MSE loss, AdamW, EMA), plus
--device (cuda by default). Trains the 64 px base model by default
(squaredcos_cap_v2) and the 256 px upsampler with --super_res (linear_plain,
conditioned on the crop box-averaged to --image_size). fp32 master weights,
bf16 compute on the card; --dtype fp32 runs with --device cpu.

    python -m minddiffusion_tpu_torch.cli.glide_train \\
        --image_caption_path_file manifests.txt --tokenizer_model cog-pretrain.model

One step (`build_step`): loss -> the gradient of every param -> grad_norm ->
clip_by_global_norm(1.0) -> AdamW (lr warmup_then_decay(lr, lr / 100,
warmup, decay), read at the update count from 0) -> EMA. Checkpoints are
{"params", "ema"}, two state dicts in the port's names, under
<output_path>/ckpt (io/glide_weights.stage_state_dict loads either into the
cascade).

Under `torchrun --nproc_per_node N` the step runs on the (--dp, --fsdp)
grid as cli/train.py's does (parallel/mesh.py): each rank's rows of the
node's batch (its t and weights with them), the noise drawn for the global
batch and cut to the rank's rows, the gradient averaged over the data
ranks or sharded by FSDP2, the EMA kept on what each rank holds (the whole
params under dp, its shards under fsdp), checkpoints gathered whole and
written by rank 0. A tp grid is reached through the API, as in the JAX
package (no flag): `create_train_state(..., mesh=make_mesh(MeshConfig(tp=
2)))` places the projections' tp pieces, and the EMA keeps each rank's
pieces.

Differences from the JAX CLI: the step is eager PyTorch (the JAX CLI jits it
with utils/xla_opts); --pretrained_ckpt is a torch state dict in the port's
names (or a glide_train checkpoint, whose "params" it takes; a JAX tree
comes across through io/glide_weights.train_checkpoint_from_jax), not an
orbax dir. Without --tokenizer_model the caption's words are hashed to ids
with CRC-32, the same ids in every process (the JAX CLI's fallback uses
Python's salted `hash`).
"""
from __future__ import annotations

import argparse
import dataclasses
import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.core.schedules import make_beta_schedule, respace_schedule
from minddiffusion_tpu_torch.data.glide_dataset import GlideTextImageDataset, read_manifests
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
from minddiffusion_tpu_torch.models.glide import (
    GlideUNetConfig, SuperResText2ImUNet, Text2ImUNet, XfConfig)
from minddiffusion_tpu_torch.parallel.collectives import global_rows, gradients, mean_over_ranks
from minddiffusion_tpu_torch.parallel.mesh import batch_sharding, data_group, shard_params
from minddiffusion_tpu_torch.pipelines.glide_cascade import init_random_glide_
from minddiffusion_tpu_torch.train.ema import init_ema, update_ema
from minddiffusion_tpu_torch.train.glide_loss import glide_diffusion_loss
from minddiffusion_tpu_torch.train.loop import LossMonitor, ProfilerCallback, Trainer
from minddiffusion_tpu_torch.train.lr_schedules import warmup_then_decay
from minddiffusion_tpu_torch.train.optim import GLIDE_ADAMW, AdamW
from minddiffusion_tpu_torch.train.trainer import step_generator
from minddiffusion_tpu_torch.utils.config import parse_with_config, set_random_seed
from minddiffusion_tpu_torch.utils.logger import configure

FALLBACK_VOCAB = 50001


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GLIDE finetuning (PyTorch + CUDA)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--image_caption_path_file", type=str, required=True)
    p.add_argument("--output_path", type=str, default="output/glide-train")
    p.add_argument("--super_res", action="store_true")
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="torch state dict in the port's names, or a glide_train checkpoint")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--super_res_image_size", type=int, default=256)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--decay_steps", type=int, default=100000)
    p.add_argument("--text_drop_p", type=float, default=0.2)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="compute dtype; fp32 only with --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug_tiny", action="store_true")
    p.add_argument("--enable_profiling", action="store_true")
    p.add_argument("--save_checkpoint_steps", type=int, default=5000)
    p.add_argument("--tokenizer_model", type=str, default=None,
                   help="sentencepiece model; CRC-32 fallback tokens if absent")
    return p


def fallback_tokens(text: str, ctx: int, n_vocab: int = FALLBACK_VOCAB):
    """(tokens, mask), each (ctx,) int32: each word's CRC-32 modulo
    n_vocab - 1, padded with n_vocab - 1 (the JAX CLI's `_encode` with a
    hash that does not change between processes)."""
    ids = [zlib.crc32(w.encode("utf-8")) % (n_vocab - 1) for w in text.split()][:ctx]
    pad = ctx - len(ids)
    return (np.asarray(ids + [n_vocab - 1] * pad, np.int32),
            np.asarray([1] * len(ids) + [0] * pad, np.int32))


def model_configs(super_res: bool, tiny: bool):
    """(UNet config, xf config): the JAX CLI's tiny configs or the base /
    upsample_256 defaults."""
    if tiny:
        return (GlideUNetConfig(in_channels=6 if super_res else 3, model_channels=32,
                                num_res_blocks=1, attention_resolutions=(2,),
                                channel_mult=(1, 2), num_head_channels=16),
                XfConfig(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64))
    return (GlideUNetConfig.upsample_256() if super_res else GlideUNetConfig.base_64(),
            XfConfig())


def build_model(super_res: bool, ucfg: GlideUNetConfig, xcfg: XfConfig, device,
                compute_dtype: torch.dtype, seed: int) -> Text2ImUNet:
    """fp32 master weights on `device`, drawn from `seed` by
    init_random_glide_, computing in `compute_dtype`."""
    with torch.device("meta"):
        model = (SuperResText2ImUNet if super_res else Text2ImUNet)(ucfg, xcfg)
    model.to_empty(device=device)
    init_random_glide_(model, torch.Generator(device=device).manual_seed(seed))
    model.compute_dtype = compute_dtype
    return model.train()


def glide_schedule(super_res: bool, diffusion_steps: int = 1000):
    betas = make_beta_schedule(diffusion_steps,
                               schedule="linear_plain" if super_res else "squaredcos_cap_v2")
    return respace_schedule(betas, set(range(diffusion_steps)))


@dataclasses.dataclass
class GlideTrainState:
    """The model (its params are the train params), the optimizer, the EMA
    (name -> tensor), `step`, the steps taken, the process grid (None: one
    process) and its tp record (None under tp 1)."""

    models: Text2ImUNet
    optimizer: AdamW
    ema: Dict[str, torch.Tensor]
    step: int = 0
    mesh: object = None
    tp: object = None

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.models.named_parameters())


def create_train_state(model: Text2ImUNet, lr: float, warmup_steps: int,
                       decay_steps: int, mesh=None) -> GlideTrainState:
    """optax.chain(clip_by_global_norm(1.0), adamw(warmup_then_decay(lr,
    lr * 0.01, warmup, decay))) over every param, and the EMA at the
    params, after the model is placed on `mesh` (tp pieces under tp > 1,
    FSDP2 under fsdp > 1)."""
    tp = shard_params({"glide": model}, mesh, {"glide": ""}) if mesh is not None else None
    params = dict(model.named_parameters())
    schedule = warmup_then_decay(lr, lr * 0.01, warmup_steps, decay_steps)
    return GlideTrainState(models=model, optimizer=AdamW(params, schedule, tp=tp, **GLIDE_ADAMW),
                           ema=init_ema(params), mesh=mesh, tp=tp)


def loss_and_grads(state: GlideTrainState, schedule, super_res: bool,
                   batch: Dict[str, torch.Tensor], noise: torch.Tensor):
    """(metrics, grads): glide_diffusion_loss of one batch on the device and
    the gradient of every param (parallel/collectives.gradients: zeros
    where the loss does not reach one; on a grid averaged over the data
    ranks, and the metrics their means over the ranks)."""
    model = state.models
    low = (batch["low_res"],) if super_res else ()

    def model_fn(x, t, tokens, mask):
        return model(x, t, *low, tokens, mask)

    loss, metrics = glide_diffusion_loss(
        model_fn, schedule, batch["image"], batch["tokens"], batch["mask"], batch["t"],
        batch["weights"], noise)
    grads = gradients(loss, lambda: state.params, set(state.optimizer.trainable), state.mesh)
    return (metrics if state.mesh is None else
            mean_over_ranks(metrics, data_group(state.mesh))), grads


def build_step(schedule, super_res: bool, ema_decay: float) -> Callable:
    """step(state, batch, seed, noise=None) -> metrics (0-d device tensors:
    loss, mse, vlb, grad_norm); updates `state` in place: loss -> gradients
    -> grad_norm, clip and AdamW (state.optimizer.step) -> EMA (the JAX
    CLI's step_fn). batch: "image" (B, H, W, 3) in [-1, 1], "tokens",
    "mask" (B, ctx), "t" (B,), "weights" (B,) and, with `super_res`,
    "low_res". `noise` (like the image) replaces the draw from the step's
    generator (seed, step). On a grid the batch is this rank's rows, and
    `noise` and the draw are the global batch's, cut to them."""

    def step(state: GlideTrainState, batch: Dict[str, torch.Tensor], seed: int,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = state.models.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        rows = batch_sharding(state.mesh)
        noise = (rows.take(noise, "noise") if noise is not None else
                 global_rows(torch.randn, rows, batch["image"].shape, device=dev,
                             generator=step_generator(seed, state.step, dev)))
        metrics, grads = loss_and_grads(state, schedule, super_res, batch, noise.to(dev))
        metrics["grad_norm"] = state.optimizer.step(grads)
        update_ema(state.ema, state.params, ema_decay)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def main(argv=None) -> GlideTrainState:
    parser = build_parser()
    args = parse_with_config(parser, argv)
    grid = common.init_grid(args.device, args.dp, args.fsdp)
    device = grid.device
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    set_random_seed(args.seed)
    logger = configure(args.output_path, formats=("human", "json"))

    ucfg, xcfg = model_configs(args.super_res, args.debug_tiny)
    model = build_model(args.super_res, ucfg, xcfg, device, common.DTYPES[args.dtype],
                        args.seed)
    if args.pretrained_ckpt:
        sd = torch.load(args.pretrained_ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(sd.get("params", sd), strict=True)
    img_size = args.super_res_image_size if args.super_res else args.image_size
    state = create_train_state(model, args.lr, args.warmup_steps, args.decay_steps,
                               mesh=grid.mesh)

    ctx = xcfg.text_ctx
    if args.tokenizer_model:
        from minddiffusion_tpu_torch.text.glide_text import (
            GlideSentencePieceTokenizer, padded_tokens_and_mask)

        sp = GlideSentencePieceTokenizer(args.tokenizer_model)

        def encode_and_pad(text):
            toks, msk = padded_tokens_and_mask(sp.encode(text), ctx, sp.end_token)
            return np.asarray(toks, np.int32), np.asarray(msk, np.int32)
    else:
        print("WARNING: no --tokenizer_model; using CRC-32 fallback tokens")

        def encode_and_pad(text):
            return fallback_tokens(text, ctx)

    dataset = GlideTextImageDataset(
        read_manifests(args.image_caption_path_file), encode_and_pad=encode_and_pad,
        batch_size=args.train_batch_size, image_size=img_size,
        text_drop_p=args.text_drop_p, seed=args.seed,
        super_res_size=args.image_size if args.super_res else None)

    callbacks = [LossMonitor(logger)]
    if args.enable_profiling:
        callbacks.append(ProfilerCallback(args.output_path, 10, 13))
    trainer = Trainer(
        step_fn=build_step(glide_schedule(args.super_res), args.super_res, args.ema_decay),
        dataset=dataset, seed=args.seed + 1, device=device, callbacks=callbacks,
        ckpt_manager=CheckpointManager(args.output_path + "/ckpt", args.save_checkpoint_steps),
        ckpt_transform=lambda sd: {"params": sd, "ema": state.ema},
        max_steps=args.max_steps)
    state = trainer.fit(state, epochs=args.epochs)
    logger.logkv("final_step", state.step)
    logger.dumpkvs()
    grid.close()
    return state


if __name__ == "__main__":
    main()
