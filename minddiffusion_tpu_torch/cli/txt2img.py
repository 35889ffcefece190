"""txt2img CLI of the PyTorch port: the flag surface of minddiffusion_tpu's
txt2img CLI (without --dump_hlo), for SD2 and Wukong-Huahua, with the
sampler choices plms, ddim and the DPM-Solver multistep, singlestep and
adaptive samplers. Defaults as in the JAX CLI: sd2 PLMS-50 at scale 9.0,
wukong DPM-Solver++ 15 steps at scale 7.5.

    python -m minddiffusion_tpu_torch.cli.txt2img --prompt "a horse" --ckpt_path sd.ckpt
    python -m minddiffusion_tpu_torch.cli.txt2img --family wukong --prompt "来自太空的长城照片"
"""
from __future__ import annotations

import argparse
import time

import torch

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.pipelines.stable_diffusion import (
    SAMPLERS, StableDiffusionPipeline)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable Diffusion txt2img (PyTorch + CUDA)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--family", choices=["sd2", "wukong"], default="sd2")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="LDM-named checkpoint: .safetensors, torch .ckpt/.pt or MindSpore .ckpt")
    p.add_argument("--outdir", type=str, default="output/txt2img-samples")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--sampler", choices=list(SAMPLERS), default=None,
                   help="default: plms for sd2, dpm for wukong")
    p.add_argument("--scale", type=float, default=None,
                   help="CFG scale; default 9.0 (sd2) / 7.5 (wukong)")
    p.add_argument("--n_samples", type=int, default=4, help="batch size")
    p.add_argument("--n_iter", type=int, default=1, help="batches to generate")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="fp32 only with --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug_tiny", action="store_true",
                   help="miniature model for smoke tests (random weights)")
    return p


def main(argv=None) -> list:
    parser = build_parser()
    args = parser.parse_args(argv)
    sampler = args.sampler or ("plms" if args.family == "sd2" else "dpm")
    scale = args.scale if args.scale is not None else (9.0 if args.family == "sd2" else 7.5)
    if sampler == "dpm" and args.sampling_steps == 50 and args.family == "wukong":
        args.sampling_steps = 15              # the wukong default, as in the JAX CLI
    device = common.resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    models = common.build_sd(args.family, args.dtype, device, tiny=args.debug_tiny,
                             ckpt_path=args.ckpt_path, seed=args.seed)
    tokenizer = common.tokenizer_for(args.family)
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=args.H, width=args.W, num_steps=args.sampling_steps,
        sampler=sampler, guidance_scale=scale, batch_size=args.n_samples)
    tokens = torch.as_tensor(tokenizer.tokenize([args.prompt] * args.n_samples))
    uncond = torch.as_tensor(tokenizer.tokenize([args.negative_prompt] * args.n_samples))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    all_paths = []
    for _ in range(args.n_iter):
        t0 = time.time()
        images = fn(models, tokens, uncond, generator).cpu()
        print(f"the infer time of a batch is {time.time() - t0:.3f}s")
        all_paths += common.save_images(images, args.outdir)
    print(f"saved {len(all_paths)} images to {args.outdir}")
    return all_paths


if __name__ == "__main__":
    main()
