"""Serve txt2img over HTTP with micro-batching (the flags of
minddiffusion_tpu's serve CLI, plus --device, cuda by default).

    python -m minddiffusion_tpu_torch.cli.serve --family sd2 --ckpt sd2.ckpt \\
        --height 512 --width 512 --steps 50 --batch_size 8 --port 8000
    python -m minddiffusion_tpu_torch.cli.serve --family glide --ckpt glide.pt \\
        --tokenizer_model cog-pretrain.model --batch_size 8

POST /v1/txt2img {"prompt": "...", "seed": 42} -> PNG (base64). The engine
pads partial batches onto the one pipeline, so the latency at low traffic
is one batch time. (prompt, seed) gives the same image whatever it is
batched with (SD: explicit x_T noise; GLIDE: row_seeds).

--ckpt reads what the txt2img and glide_txt2img CLIs read: an LDM-named
torch checkpoint (sd2, wukong) or a torch state dict in the port's GLIDE
names; without it the weights are seeded random. The SD families tokenize
with the CLIP BPE / zh wordpiece vocab (`bpe_simple_vocab_16e6.txt.gz`,
`vocab_zh.txt` in $MINDDIFFUSION_TPU_ASSETS or assets/); GLIDE without
--tokenizer_model serves placeholder token ids, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import os
import zipfile

import numpy as np
import torch

from minddiffusion_tpu_torch.cli import common

_FORMAT_QUEUED = ("the .safetensors and MindSpore .ckpt readers are queued in ROADMAP.md "
                  "Queue 1, 'io, export and eval'; orbax directories stay with the JAX "
                  "package")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="sd2", choices=["sd2", "wukong", "glide"])
    p.add_argument("--ckpt", default=None, help="LDM torch .ckpt (sd2, wukong) or the "
                   "port's GLIDE state dict; seeded random weights if omitted")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--steps", type=int, default=50,
                   help="SD sampler steps (GLIDE uses --denoise_steps)")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "plms", "dpm"])
    p.add_argument("--scale", type=float, default=9.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="fp32 only with --device cpu")
    p.add_argument("--device", default="cuda")
    p.add_argument("--debug_tiny", action="store_true")
    # GLIDE-only knobs (mirroring cli/glide_txt2img.py)
    p.add_argument("--tokenizer_model", default=None,
                   help="GLIDE zh sentencepiece model (cog-pretrain.model)")
    p.add_argument("--denoise_steps", default="60")
    p.add_argument("--super_res_steps", default="fast27")
    p.add_argument("--no_srgan", action="store_true")
    p.add_argument("--glide_scale", type=float, default=5.0)
    return p


def check_ckpt(path: str) -> None:
    """Refuse what the port cannot read yet: .safetensors, orbax
    directories, and .ckpt files that are not torch checkpoints (a torch
    checkpoint is a zip archive or a pickle; a MindSpore one is neither)."""
    if os.path.isdir(path):
        raise SystemExit(f"--ckpt {path}: an orbax directory; {_FORMAT_QUEUED}")
    if path.endswith(".safetensors"):
        raise SystemExit(f"--ckpt {path}: .safetensors is not read yet; {_FORMAT_QUEUED}")
    with open(path, "rb") as f:
        is_pickle = f.read(1) == b"\x80"
    if not (is_pickle or zipfile.is_zipfile(path)):
        raise SystemExit(f"--ckpt {path}: not a torch checkpoint (MindSpore .ckpt?); "
                         f"{_FORMAT_QUEUED}")


def _device(args) -> torch.device:
    device = common.resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bf16":
        raise SystemExit("--dtype fp32 runs only with --device cpu: the CUDA kernels take bf16")
    if args.ckpt:
        check_ckpt(args.ckpt)
    return device


def _build_sd_engine(args, tokenize=None):
    """(engine, description) for --family sd2 / wukong. `tokenize(prompt)
    -> (77,) ints` replaces the family's tokenizer (which needs its vocab
    file)."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline
    from minddiffusion_tpu_torch.serving import BatchingEngine, SDAdapter

    device = _device(args)
    models = common.build_sd(args.family, args.dtype, device, tiny=args.debug_tiny,
                             ckpt_path=args.ckpt)
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=args.height, width=args.width, num_steps=args.steps, sampler=args.sampler,
        guidance_scale=args.scale, batch_size=args.batch_size)
    if tokenize is None:
        tok = common.tokenizer_for(args.family)
        tokenize = lambda s: tok.tokenize([s])[0]  # noqa: E731
    f = models.latent_factor
    adapter = SDAdapter(fn, models, tokenize, (args.height // f, args.width // f))
    desc = f"{args.sampler}-{args.steps} {args.height}x{args.width}"
    return BatchingEngine(adapter, batch_size=args.batch_size,
                          max_wait_ms=args.max_wait_ms), desc


def _build_glide_engine(args, tokenize=None):
    """(engine, description) for --family glide. `tokenize(prompt) ->
    (tokens, mask)` replaces the sentencepiece model / placeholder ids."""
    # SD-only geometry and sampler flags have no effect on the fixed
    # 64 -> 256 -> 1024 cascade: warn instead of dropping them silently
    sd_only = {"height": 512, "width": 512, "steps": 50, "sampler": "ddim", "scale": 9.0}
    dropped = [f"--{k}" for k, default in sd_only.items() if getattr(args, k) != default]
    if dropped:
        print(f"[serve] WARNING: {', '.join(dropped)} ignored for --family glide (use "
              f"--denoise_steps/--super_res_steps/--glide_scale; geometry is the fixed "
              f"cascade)")
    from minddiffusion_tpu_torch.cli.glide_txt2img import tiny_kwargs
    from minddiffusion_tpu_torch.pipelines.glide_cascade import (
        GlideCascadePipeline, GlideModels)
    from minddiffusion_tpu_torch.serving import BatchingEngine, GlideAdapter

    device = _device(args)
    if args.ckpt is None:
        print("WARNING: no checkpoint — RANDOM weights (noise images)")
    models = GlideModels.create(
        dtype=common.DTYPES[args.dtype], base_respacing=args.denoise_steps,
        sr_respacing=args.super_res_steps, with_srgan=not args.no_srgan, device=device,
        generator=(torch.Generator(device=device).manual_seed(0)
                   if args.ckpt is None else None),
        **(tiny_kwargs() if args.debug_tiny else {}))
    if args.ckpt is not None:
        sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        models.load_state_dict({k: v.float().numpy() for k, v in sd.items()})
    sizes = dict(base_size=16, sr_size=32) if args.debug_tiny else {}
    fn = GlideCascadePipeline(models).build_generate(
        batch_size=args.batch_size, guidance_scale=args.glide_scale,
        run_srgan=not args.no_srgan, **sizes)
    ctx = models.base.xf_config.text_ctx
    if tokenize is None and args.tokenizer_model:
        from minddiffusion_tpu_torch.text.glide_text import (
            GlideSentencePieceTokenizer, padded_tokens_and_mask)

        sp = GlideSentencePieceTokenizer(args.tokenizer_model)
        tokenize = lambda s: padded_tokens_and_mask(  # noqa: E731
            sp.encode(s), ctx, sp.end_token)
    elif tokenize is None:
        print("WARNING: no --tokenizer_model — placeholder token ids")
        tokenize = lambda s: (np.ones((ctx,), np.int64),  # noqa: E731
                              np.ones((ctx,), np.int64))
    stage = "super_res" if args.no_srgan else "srgan"
    adapter = GlideAdapter(fn, models, tokenize, stage=stage)
    desc = f"glide {args.denoise_steps}+{args.super_res_steps} -> {stage}"
    return BatchingEngine(adapter, batch_size=args.batch_size,
                          max_wait_ms=args.max_wait_ms), desc


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)

    from minddiffusion_tpu_torch.serving import make_server

    if args.family == "glide":
        engine, desc = _build_glide_engine(args)
    else:
        engine, desc = _build_sd_engine(args)
    engine.start()
    device = engine.adapter.device
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] warming {desc} b{args.batch_size} on {kind}...", flush=True)
    engine.submit("warmup", seed=0)  # builds the kernels before traffic
    srv = make_server(engine, args.host, args.port,
                      info={"family": args.family, "config": desc,
                            "batch_size": args.batch_size, "dtype": args.dtype,
                            "device": kind})
    print(f"[serve] listening on {args.host}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
