"""GLIDE cascade CLI of the PyTorch port: the flags of minddiffusion_tpu's
glide_txt2img CLI (60-step guided base, "fast27" super-res, SRGAN x4; the
three stages are saved), plus --device (cuda by default).

    python -m minddiffusion_tpu_torch.cli.glide_txt2img --prompt "一只猫" \\
        --tokenizer_model cog-pretrain.model --ckpt_path glide.pt

--ckpt_path is a torch state dict in the port's names (io/glide_weights.py,
stage prefixes "base.", "super_res.", "srgan."); without it the weights are
seeded random. Without --tokenizer_model the prompt is not read and
placeholder token ids stand in, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.pipelines.glide_cascade import (
    UNCOND_MODES, GlideCascadePipeline, GlideModels)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GLIDE cascade txt2img (PyTorch + CUDA)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="torch state dict in the port's GLIDE names")
    p.add_argument("--tokenizer_model", type=str, default=None,
                   help="sentencepiece model (cog-pretrain.model)")
    p.add_argument("--outdir", type=str, default="output/glide-samples")
    p.add_argument("--pics_generated", type=int, default=8)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--denoise_steps", type=str, default="60")
    p.add_argument("--super_res_steps", type=str, default="fast27")
    p.add_argument("--no_srgan", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="fp32 only with --device cpu")
    p.add_argument("--uncond_mode", choices=list(UNCOND_MODES), default="per_generation",
                   help="per_step = the reference's per-step random uncond tokens")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug_tiny", action="store_true",
                   help="miniature models at 16 px base / 32 px super-res for smoke tests")
    return p


def tiny_kwargs() -> dict:
    """A structurally complete miniature of the cascade for smoke tests."""
    from minddiffusion_tpu_torch.models.glide import GlideUNetConfig, XfConfig

    unet = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_head_channels=16)
    return dict(base_unet=GlideUNetConfig(**unet),
                sr_unet=GlideUNetConfig(in_channels=6, **unet),
                xf=XfConfig(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64))


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bf16":
        parser.error("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.ckpt_path is None:
        print("WARNING: no checkpoint — RANDOM weights (noise images)")
    models = GlideModels.create(
        dtype=common.DTYPES[args.dtype], base_respacing=args.denoise_steps,
        sr_respacing=args.super_res_steps, with_srgan=not args.no_srgan, device=device,
        generator=generator if args.ckpt_path is None else None,
        **(tiny_kwargs() if args.debug_tiny else {}))
    if args.ckpt_path is not None:
        sd = torch.load(args.ckpt_path, map_location="cpu", weights_only=True)
        models.load_state_dict({k: v.float().numpy() for k, v in sd.items()})
    ctx = models.base.xf_config.text_ctx
    if args.tokenizer_model:
        from minddiffusion_tpu_torch.text.glide_text import (
            GlideSentencePieceTokenizer, prepare_cond_tokens)

        tokens, mask = prepare_cond_tokens(GlideSentencePieceTokenizer(args.tokenizer_model),
                                           args.prompt, args.pics_generated, ctx)
    else:
        print("WARNING: no tokenizer model — using placeholder token ids")
        tokens = mask = np.ones((args.pics_generated, ctx), np.int32)
    sizes = dict(base_size=16, sr_size=32) if args.debug_tiny else {}
    fn = GlideCascadePipeline(models).build_generate(
        batch_size=args.pics_generated, guidance_scale=args.guidance_scale,
        run_srgan=not args.no_srgan, uncond_mode=args.uncond_mode, **sizes)
    timings: dict = {}
    t0 = time.time()
    out = fn(models, tokens, mask, generator, timings=timings)
    print(f"the infer time of a batch is {time.time() - t0:.3f}s ("
          + ", ".join(f"{k} {v:.3f}s" for k, v in timings.items()) + ")")
    saved = {stage: common.save_images(images, f"{args.outdir}/{stage}")
             for stage, images in out.items()}
    for stage, paths in saved.items():
        print(f"{stage}: saved {len(paths)} to {args.outdir}/{stage}")
    return saved


if __name__ == "__main__":
    main()
