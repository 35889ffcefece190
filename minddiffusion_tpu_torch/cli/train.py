"""Training CLI of the PyTorch port: the flag surface of minddiffusion_tpu's
train CLI (stablediffusionv2/run_train.py:212-243 + train_config.json), with
DreamBooth (`--train_mode dreambooth`) and LoRA (`--train_mode lora`), for
SD2 and Wukong-Huahua. fp32 master weights, bf16 compute on the card (the
JAX model's dtype=bf16, param_dtype=fp32); `--dtype fp32` runs fp32 compute
with `--device cpu`.

    python -m minddiffusion_tpu_torch.cli.train --family sd2 --data_path /data
    python -m minddiffusion_tpu_torch.cli.train --train_mode lora --data_path /data
    python -m minddiffusion_tpu_torch.cli.train --train_mode dreambooth \\
        --instance_data_dir inst/ --class_data_dir cls/

Without a launcher: one process on one device (`--dp` -1 or 1, `--fsdp`
1). Under `torchrun --nproc_per_node N` the step runs on the grid
MeshConfig(dp=--dp, fsdp=--fsdp).resolve(N) (parallel/mesh.py), one rank a
GPU (cuda:LOCAL_RANK, NCCL; gloo with --device cpu): `--train_batch_size`
is one node's batch, split over its ranks; the gradient is averaged over
the data ranks, and under --fsdp > 1 the UNet and the text encoder are
sharded by FSDP2:

    torchrun --nproc_per_node 2 -m minddiffusion_tpu_torch.cli.train --dp 2 ...
    torchrun --nproc_per_node 2 -m minddiffusion_tpu_torch.cli.train --fsdp 2 ...

Checkpoints hold the params (LoRA: the adapters only) as LDM-named torch
state dicts under `<output_path>/ckpt`, gathered whole and written by rank 0.
"""
from __future__ import annotations

import argparse

import torch

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.data import DreamBoothDataset, load_data
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
from minddiffusion_tpu_torch.train.loop import LossMonitor, ProfilerCallback, Trainer
from minddiffusion_tpu_torch.train.optim import lora_checkpoint_transform
from minddiffusion_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                   make_train_step)
from minddiffusion_tpu_torch.utils.config import parse_with_config, set_random_seed
from minddiffusion_tpu_torch.utils.logger import configure


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable Diffusion training (PyTorch + CUDA)")
    p.add_argument("--config", type=str, default=None,
                   help="JSON overlay for unset flags (train_config.json semantics)")
    p.add_argument("--data_path", type=str, default=None,
                   help="CSV-manifest dir; required unless --train_mode dreambooth")
    p.add_argument("--output_path", type=str, default="output/train")
    p.add_argument("--family", choices=["sd2", "wukong"], default="wukong")
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="LDM-named checkpoint: .safetensors, torch .ckpt/.pt or MindSpore .ckpt")
    p.add_argument("--train_mode", choices=["finetune", "dreambooth", "lora"],
                   default="finetune")
    p.add_argument("--train_batch_size", type=int, default=3)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--image_filter_size", type=int, default=256)
    p.add_argument("--random_crop", action="store_true")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--start_learning_rate", type=float, default=1e-5)
    p.add_argument("--end_learning_rate", type=float, default=1e-7)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--decay_steps", type=int, default=100000)
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--save_checkpoint_steps", type=int, default=10000)
    p.add_argument("--keep_checkpoint_max", type=int, default=10)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="compute dtype; fp32 only with --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug_tiny", action="store_true",
                   help="miniature model for smoke tests (random weights)")
    p.add_argument("--enable_profiling", action="store_true")
    p.add_argument("--profile_start_step", type=int, default=10)
    p.add_argument("--profile_stop_step", type=int, default=13)
    # dreambooth extras (run_db_train.py)
    p.add_argument("--instance_data_dir", type=str, default=None)
    p.add_argument("--class_data_dir", type=str, default=None)
    p.add_argument("--token", type=str, default="sks")
    p.add_argument("--class_word", type=str, default="person")
    p.add_argument("--train_data_repeats", type=int, default=100)
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    return p


def main(argv=None):
    parser = build_parser()
    args = parse_with_config(parser, argv)
    dreambooth = args.train_mode == "dreambooth"
    if dreambooth and not (args.instance_data_dir and args.class_data_dir):
        raise SystemExit("--train_mode dreambooth needs --instance_data_dir and "
                         "--class_data_dir")
    if not dreambooth and not args.data_path:
        raise SystemExit("--data_path is required unless --train_mode dreambooth")
    grid = common.init_grid(args.device, args.dp, args.fsdp)
    device = grid.device
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    set_random_seed(args.seed)
    logger = configure(args.output_path, formats=("human", "json"))

    lora = args.train_mode == "lora"
    models = common.build_sd(args.family, args.dtype, device, tiny=args.debug_tiny,
                             ckpt_path=args.pretrained_ckpt, seed=args.seed,
                             param_dtype=torch.float32, enable_lora=lora,
                             exact_attention=True)
    tokenizer = common.tokenizer_for(args.family)
    if dreambooth:
        dataset = DreamBoothDataset(
            args.instance_data_dir, args.class_data_dir, args.token, args.class_word,
            tokenizer.tokenize, args.train_batch_size, args.image_size,
            args.train_data_repeats, args.seed)
    else:
        dataset = load_data(
            args.data_path, args.train_batch_size, tokenizer.tokenize,
            image_size=args.image_size, image_filter_size=args.image_filter_size,
            random_crop=args.random_crop, seed=args.seed)

    config = TrainConfig(
        start_lr=args.start_learning_rate, end_lr=args.end_learning_rate,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        weight_decay=args.weight_decay, beta1=args.betas[0], beta2=args.betas[1],
        trainable="lora" if lora else "unet", prior_loss_weight=args.prior_loss_weight)
    state = create_train_state(models, config, mesh=grid.mesh)

    callbacks = [LossMonitor(logger)]
    if args.enable_profiling:
        callbacks.append(ProfilerCallback(args.output_path, args.profile_start_step,
                                          args.profile_stop_step))
    trainer = Trainer(
        step_fn=make_train_step(config, dreambooth=dreambooth), dataset=dataset,
        seed=args.seed, device=device, callbacks=callbacks,
        ckpt_manager=CheckpointManager(args.output_path + "/ckpt",
                                       args.save_checkpoint_steps, args.keep_checkpoint_max),
        ckpt_transform=(lora_checkpoint_transform(state.models.state_dict())
                        if lora else None),
        max_steps=args.max_steps)
    state = trainer.fit(state, epochs=args.epochs)
    logger.logkv("final_step", state.step)
    logger.dumpkvs()
    grid.close()
    return state


if __name__ == "__main__":
    main()
