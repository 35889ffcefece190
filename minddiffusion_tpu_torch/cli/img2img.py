"""img2img CLI of the PyTorch port (the flag surface of minddiffusion_tpu's
img2img CLI, sd2 or wukong): encode the init image, q_sample it to the strength's DDIM
step, denoise from there, decode.

    python -m minddiffusion_tpu_torch.cli.img2img --prompt "a horse" \
        --init_image in.png --strength 0.75 --ckpt_path sd.ckpt
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from PIL import Image

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.core import latents
from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable Diffusion img2img (PyTorch + CUDA)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--init_image", type=str, required=True)
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--family", choices=["sd2", "wukong"], default="sd2")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="LDM-named checkpoint: .safetensors, torch .ckpt/.pt or MindSpore .ckpt")
    p.add_argument("--outdir", type=str, default="output/img2img-samples")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=9.0, help="CFG scale")
    p.add_argument("--n_samples", type=int, default=1, help="batch size")
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
    device = common.resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    models = common.build_sd(args.family, args.dtype, device, tiny=args.debug_tiny,
                             ckpt_path=args.ckpt_path, seed=args.seed)
    tokenizer = common.tokenizer_for(args.family)
    fn = StableDiffusionPipeline(models).build_img2img(
        height=args.H, width=args.W, num_steps=args.sampling_steps,
        strength=args.strength, guidance_scale=args.scale)
    img = Image.open(args.init_image).convert("RGB").resize(
        (args.W, args.H), Image.BICUBIC)
    init = latents.images_to_unit_range(torch.from_numpy(np.asarray(img)))
    init = init[None].repeat(args.n_samples, 1, 1, 1)
    tokens = torch.as_tensor(tokenizer.tokenize([args.prompt] * args.n_samples))
    uncond = torch.as_tensor(tokenizer.tokenize([""] * args.n_samples))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    images = fn(models, init, tokens, uncond, generator).cpu()
    print(f"the infer time of a batch is {time.time() - t0:.3f}s")
    paths = common.save_images(images, args.outdir)
    print(f"saved {len(paths)} images to {args.outdir}")
    return paths


if __name__ == "__main__":
    main()
