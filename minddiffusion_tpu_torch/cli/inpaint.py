"""Inpainting CLI of the PyTorch port (the flag surface of minddiffusion_tpu's
inpaint CLI): image + mask + prompt through the 9-channel Wukong-Huahua
inpaint UNet, PLMS-50 at scale 7.5 by default, with the --aug choices
resize / crop / resizecrop / none.

    python -m minddiffusion_tpu_torch.cli.inpaint --prompt "一只猫" \
        --image_path in.png --mask_path mask.png --ckpt_path inpaint.ckpt

The mask follows the MindSpore reference, not the JAX CLI: after the aug,
a pixel is repainted where the last channel of its RGB value is > 127.5
(the JAX CLI takes the luminance and binarises it at 0.5 in the pipeline;
the two agree on black and white masks, and differ on coloured ones).
Under MDT_WINO_TUNE=dma=0 its Winograd sites take the gathered-tile kernel.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from PIL import Image

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable Diffusion inpainting (PyTorch + CUDA)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--mask_path", type=str, required=True,
                   help="white (last channel > 127.5) = region to repaint")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="LDM-named torch checkpoint (.ckpt/.pt)")
    p.add_argument("--outdir", type=str, default="output/inpaint-samples")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="fp32 only with --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--aug", choices=["resize", "crop", "resizecrop", "none"],
                   default="resize",
                   help="preprocessing: resize = scale both to HxW; crop = HxW "
                        "window centred on the mask; resizecrop = crop a window "
                        "the mask spans mask_ratio of, then scale to HxW; "
                        "none = use as-is")
    p.add_argument("--mask_ratio", type=float, default=0.75,
                   help="resizecrop: fraction of the crop the mask spans")
    p.add_argument("--debug_tiny", action="store_true",
                   help="miniature model for smoke tests (random weights)")
    return p


def aug_func(args, image: Image.Image, mask_image: Image.Image):
    """The --aug preprocessing, as the JAX CLI's `_aug_func`: the mask's
    centroid and extent come from pixels whose first channel is > 127.5;
    crops are clipped so the window stays inside the image."""
    w, h = args.W, args.H
    if args.aug == "resize":
        return lambda im: im.resize((w, h), Image.BICUBIC)
    if args.aug == "none":
        return lambda im: im
    mask_idx = np.where(np.asarray(mask_image.convert("RGB"))[:, :, 0] > 127.5)
    if mask_idx[0].size == 0:
        raise SystemExit("--aug crop/resizecrop needs a non-empty mask")
    center = np.array([mask_idx[1].mean(), mask_idx[0].mean()]).astype(int)   # (x, y)
    if args.aug == "crop":
        cw, ch = w, h
    else:  # resizecrop: a window the mask spans mask_ratio of
        mask_range = max(idx.max() - idx.min() for idx in mask_idx)
        cw = ch = math.ceil(mask_range / args.mask_ratio)
    cx = int(np.clip(center[0], cw // 2, max(image.size[0] - cw // 2, cw // 2)))
    cy = int(np.clip(center[1], ch // 2, max(image.size[1] - ch // 2, ch // 2)))
    box = (cx - cw // 2, cy - ch // 2, cx + cw // 2, cy + ch // 2)
    if args.aug == "crop":
        return lambda im: im.crop(box)
    return lambda im: im.crop(box).resize((w, h), Image.BICUBIC)


def image_array(img: Image.Image) -> np.ndarray:
    """(1, H, W, 3) fp32 in [-1, 1]."""
    return (np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0)[None]


def mask_array(img: Image.Image) -> np.ndarray:
    """(1, H, W, 1) fp32 in {0, 1}: 1 where the last channel of the RGB
    value is > 127.5 (the MindSpore reference's threshold)."""
    return (np.asarray(img.convert("RGB"))[:, :, -1] > 127.5).astype(np.float32)[None, ..., None]


def main(argv=None) -> list:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    models = common.build_sd("wukong-inpaint", args.dtype, device, tiny=args.debug_tiny,
                             ckpt_path=args.ckpt_path, seed=args.seed)
    tokenizer = common.tokenizer_for("wukong-inpaint")
    fn = StableDiffusionPipeline(models).build_inpaint(
        height=args.H, width=args.W, num_steps=args.sampling_steps,
        guidance_scale=args.scale)
    img_pil, mask_pil = Image.open(args.image_path), Image.open(args.mask_path)
    aug = aug_func(args, img_pil, mask_pil)
    image, mask = image_array(aug(img_pil)), mask_array(aug(mask_pil))
    if image.shape[1:3] != (args.H, args.W):
        raise SystemExit(
            f"--aug {args.aug} produced {image.shape[2]}x{image.shape[1]}, expected "
            f"{args.W}x{args.H}: use --aug resize/resizecrop or a matching --H/--W")
    b = args.n_samples
    image = torch.from_numpy(np.repeat(image, b, 0))
    mask = torch.from_numpy(np.repeat(mask, b, 0))
    tokens = torch.as_tensor(tokenizer.tokenize([args.prompt] * b))
    uncond = torch.as_tensor(tokenizer.tokenize([""] * b))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    images = fn(models, image, mask, tokens, uncond, generator).cpu()
    print(f"the infer time of a batch is {time.time() - t0:.3f}s")
    paths = common.save_images(images, args.outdir)
    print(f"saved {len(paths)} images to {args.outdir}")
    return paths


if __name__ == "__main__":
    main()
