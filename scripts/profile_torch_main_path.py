"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/profile_torch_main_path.py [--out output/profile_torch_main_path.txt]
        [--family sd2|wukong|glide] [--height 512 --width 512 --batch 8]

SD2 (raw-exp softmax at the packed-attention sites, as the main path) or
Wukong-Huahua (SD1 UNet, zh CLIP; exact softmax) at full width with seeded
random weights, bf16, at the given image size and batch (default: the main
path, 512^2 batch 8, so 64x64 latents and a CFG batch of 16 for the text
encoder and the UNet). Prints, one line each: the
card's name and power limit; the ms of one text encode, one UNet eval, one
VAE decode and one VAE encode (CUDA events, median after warm-up); the wall
ms and the summed device kernel ms of a UNet eval under torch.profiler
(their gap is the share of the eval the card idles); and the Winograd
kernels (K2, and K3 on gathered tiles) against cuDNN's conv (F.conv2d,
channels-last) at five of their gated sites. The profiler's per-op table goes to `--out`.

`--family glide` profiles the Taichu-GLIDE cascade at the JAX package's
defaults (64 px base, 60 ancestral steps, guidance 5.0; 256 px "fast27"
super-res; SRGAN x4 in fp32) at `--batch` (the size flags are not read):
seconds per stage of one cascade (host clock, the device synchronised at
each stage boundary), the ms of one xf encode, one base eval (CFG batch
2B), one super-res eval and one SRGAN call (CUDA events), and for the whole
cascade and each eval kind the wall ms against the summed device kernel ms
under torch.profiler.

`--train` profiles one SD train step of `--family` sd2 or wukong instead
(fp32 master weights, bf16 compute, exact softmax, seeded random weights
and batch, at the given size; `--batch` defaults to 3 there, the train
CLI's; `--lora` trains the UNet's adapters only): the ms (CUDA events,
median) of the loss forward (VAE encode under no_grad, text encoder, UNet),
of the forward plus the gradient of every UNet and text-encoder param, and
of the whole step (the finite guard and the AdamW update added), and the
step's wall ms against its summed device kernel ms under torch.profiler.
`--train --family glide` does the same for the GLIDE train step of
cli/glide_train.py (xf and UNet forward, the VLB + MSE loss; the gradient
of every param; clip, AdamW and the EMA), for the base at 64 px (batch 8)
and the super-res at 256 px (batch 2), `--batch` replacing both batches.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROFILED_EVALS = 3
CONV_SITES = [  # (H = W, C_in, C_out), batch 16, no prologue
    (32, 640, 640), (16, 2560, 1280), (32, 1280, 1280), (16, 1280, 1280),
    (32, 1920, 640)]


def cuda_ms(fn, warmup: int = 2, runs: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn, runs: int = 1):
    """(wall ms per run, summed device kernel ms per run, the profiler's
    key averages) of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    averages = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in averages        # kernel rows only
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation) / 1e3 / runs
    return wall_ms, device_ms, averages


def write_table(path: str, title: str, averages, mode: str = "w") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, mode) as f:
        f.write(title + "\n")
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=30) + "\n")


def profile_glide(args) -> None:
    from minddiffusion_tpu_torch.pipelines.glide_cascade import (
        GlideCascadePipeline, GlideModels)

    gen = torch.Generator(device="cuda").manual_seed(0)
    models = GlideModels.create(dtype=torch.bfloat16, device="cuda", generator=gen)
    b, xf = args.batch, models.base.xf_config
    tokens = torch.full((b, xf.text_ctx), xf.n_vocab - 1, dtype=torch.long, device="cuda")
    tokens[:, :12] = torch.arange(101, 113, device="cuda")
    mask = (tokens != xf.n_vocab - 1).long()
    fn = GlideCascadePipeline(models).build_generate(batch_size=b)
    run = lambda timings=None: fn(models, tokens, mask,  # noqa: E731
                                  torch.Generator(device="cuda").manual_seed(1), timings=timings)
    print(f"glide cascade batch {b} (base CFG batch {2 * b})")
    run()
    stages: dict = {}
    t0 = time.perf_counter()
    run(stages)
    total_s = time.perf_counter() - t0
    print(f"cascade_s={total_s:.3f} " + " ".join(f"{k}_s={v:.3f}" for k, v in stages.items()))
    x64 = torch.randn(2 * b, 64, 64, 3, generator=gen, device="cuda")
    x256 = torch.randn(b, 256, 256, 3, generator=gen, device="cuda")
    low = torch.rand(b, 64, 64, 3, generator=gen, device="cuda") * 2 - 1
    t = torch.full((1,), 501, device="cuda")
    base, sr = models.base, models.super_res
    with torch.inference_mode(), base.hoisted_winograd(), sr.hoisted_winograd():
        xp2, xo2 = base.encode_text(torch.cat([tokens, tokens]), torch.cat([mask, mask]))
        xp, xo = sr.encode_text(tokens, mask)
        evals = {"base": lambda: base.denoise(x64, t, xp2, xo2),
                 "super_res": lambda: sr.denoise(x256, t, low, xp, xo),
                 "srgan": lambda: models.srgan(x256.clamp(-1, 1))}
        xf_ms = cuda_ms(lambda: base.encode_text(torch.cat([tokens, tokens]),
                                                 torch.cat([mask, mask])))
        ms = {k: cuda_ms(f, runs=3) for k, f in evals.items()}
        print(f"xf_encode_B{2 * b}_ms={xf_ms:.3f} base_eval_B{2 * b}_ms={ms['base']:.3f} "
              f"super_res_eval_B{b}_ms={ms['super_res']:.3f} srgan_B{b}_ms={ms['srgan']:.3f}")
        wall, dev, averages = profiled(run)
        print(f"profiled cascade: wall_ms={wall:.3f} device_kernel_ms={dev:.3f} "
              f"idle_share={1 - dev / wall:.3f}")
        write_table(args.out, f"per-op totals over one GLIDE cascade (batch {b})", averages)
        for name, f in evals.items():
            wall, dev, averages = profiled(f, PROFILED_EVALS)
            print(f"profiled {name} eval: wall_ms={wall:.3f} device_kernel_ms={dev:.3f} "
                  f"idle_share={1 - dev / wall:.3f}")
            write_table(args.out, f"per-op totals over {PROFILED_EVALS} {name} calls",
                        averages, mode="a")


def profile_train(args) -> None:
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels
    from minddiffusion_tpu_torch.train import trainer

    gen = torch.Generator(device="cuda").manual_seed(0)
    models = SDModels.create(family=args.family, dtype=torch.bfloat16,
                             param_dtype=torch.float32, attn_impl=None, device="cuda",
                             generator=gen, enable_lora=args.lora)
    config = trainer.TrainConfig(warmup_steps=0, trainable="lora" if args.lora else "unet")
    state = trainer.create_train_state(models, config)
    step = trainer.make_train_step(config)
    loss_and_grads = trainer.make_loss_and_grads(config)
    b = args.batch or 3
    vocab = models.text_encoder.config.vocab_size
    batch = {"image": torch.rand(b, args.height, args.width, 3, generator=gen,
                                 device="cuda") * 2 - 1,
             "tokens": torch.randint(0, vocab, (b, 77), generator=gen, device="cuda")}
    print(f"train {args.family}{' lora' if args.lora else ''} {args.height}x{args.width} "
          f"batch {b}")
    fwd_ms = cuda_ms(lambda: trainer.diffusion_loss(models, batch["image"], batch["tokens"],
                                                    gen), runs=3)
    grad_ms = cuda_ms(lambda: loss_and_grads(state, batch, gen), runs=3)
    step_ms = cuda_ms(lambda: step(state, batch, 0), runs=3)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, 0)
    print(f"loss_forward_ms={fwd_ms:.3f} forward_and_grads_ms={grad_ms:.3f} "
          f"step_ms={step_ms:.3f} img_per_s={b / step_ms * 1e3:.4f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    wall, dev, averages = profiled(lambda: step(state, batch, 0), PROFILED_EVALS)
    print(f"profiled train step: wall_ms={wall:.3f} device_kernel_ms={dev:.3f} "
          f"idle_share={1 - dev / wall:.3f}")
    write_table(args.out, f"per-op totals over {PROFILED_EVALS} train steps (batch {b})",
                averages)


def profile_glide_train(args) -> None:
    from minddiffusion_tpu_torch.cli import glide_train as gt
    from minddiffusion_tpu_torch.train.glide_loss import glide_diffusion_loss

    gen = torch.Generator(device="cuda").manual_seed(0)
    mode = "w"
    for stage, b, size in (("base", args.batch or 8, 64), ("super_res", args.batch or 2, 256)):
        sr = stage == "super_res"
        ucfg, xcfg = gt.model_configs(sr, tiny=False)
        model = gt.build_model(sr, ucfg, xcfg, "cuda", torch.bfloat16, seed=0)
        state = gt.create_train_state(model, 1e-4, 0, 100_000)
        schedule = gt.glide_schedule(sr)
        step = gt.build_step(schedule, sr, 0.9999)
        image = torch.randint(0, 256, (b, size, size, 3), generator=gen, device="cuda")
        tokens = torch.full((b, xcfg.text_ctx), xcfg.n_vocab - 1, device="cuda")
        tokens[:, :12] = torch.arange(101, 113, device="cuda")
        batch = {"image": image.float() / 127.5 - 1, "tokens": tokens,
                 "mask": (tokens != xcfg.n_vocab - 1).long(),
                 "t": torch.randint(0, 1000, (b,), generator=gen, device="cuda"),
                 "weights": torch.ones(b, device="cuda")}
        if sr:
            batch["low_res"] = batch["image"].reshape(b, 64, 4, 64, 4, 3).mean((2, 4))
        noise = torch.randn(image.shape, generator=gen, device="cuda")
        low = (batch["low_res"],) if sr else ()

        def forward():
            return glide_diffusion_loss(
                lambda x, t, tk, mk: model(x, t, *low, tk, mk), schedule, batch["image"],
                batch["tokens"], batch["mask"], batch["t"], batch["weights"], noise)

        print(f"glide {stage} train {size}x{size} batch {b}")
        fwd_ms = cuda_ms(forward, runs=3)
        grad_ms = cuda_ms(lambda: gt.loss_and_grads(state, schedule, sr, batch, noise), runs=3)
        step_ms = cuda_ms(lambda: step(state, batch, 0), runs=3)
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, 0)
        print(f"loss_forward_ms={fwd_ms:.3f} forward_and_grads_ms={grad_ms:.3f} "
              f"step_ms={step_ms:.3f} img_per_s={b / step_ms * 1e3:.4f} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        wall, dev, averages = profiled(lambda: step(state, batch, 0), PROFILED_EVALS)
        print(f"profiled train step: wall_ms={wall:.3f} device_kernel_ms={dev:.3f} "
              f"idle_share={1 - dev / wall:.3f}")
        write_table(args.out, f"per-op totals over {PROFILED_EVALS} GLIDE {stage} train "
                    f"steps (batch {b})", averages, mode=mode)
        mode = "a"
        del state, model, step, batch
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="output/profile_torch_main_path.txt")
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--batch", type=int, default=None,
                        help="default 8 (inference), 3 (--train), 8 and 2 (--train --family glide)")
    parser.add_argument("--family", choices=["sd2", "wukong", "glide"], default="sd2")
    parser.add_argument("--train", action="store_true", help="profile a train step")
    parser.add_argument("--lora", action="store_true", help="with --train: LoRA mode")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    from minddiffusion_tpu_torch.ops import winograd
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.train:
        (profile_glide_train if args.family == "glide" else profile_train)(args)
        print(f"per-op table: {args.out}")
        return 0
    args.batch = args.batch or 8
    if args.family == "glide":
        profile_glide(args)
        print(f"per-op table: {args.out}")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = SDModels.create(family=args.family, dtype=torch.bfloat16,
                             attn_impl="fast" if args.family == "sd2" else None,
                             device="cuda", generator=gen)
    b, h8, w8 = args.batch, args.height // 8, args.width // 8
    tokens = torch.cat([torch.zeros(b, 77, dtype=torch.long),
                        torch.ones(b, 77, dtype=torch.long)]).cuda()
    x = torch.randn(2 * b, h8, w8, 4, generator=gen, device="cuda")
    t = torch.full((2 * b,), 501, device="cuda")
    z = torch.randn(b, h8, w8, 4, generator=gen, device="cuda")
    img = torch.rand(b, args.height, args.width, 3, generator=gen, device="cuda") * 2 - 1
    unet = models.unet
    print(f"{args.family} {args.height}x{args.width} batch {b} (CFG batch {2 * b})")
    with torch.inference_mode(), unet.hoisted_winograd():
        ctx = models.text_encoder(tokens)
        text_ms = cuda_ms(lambda: models.text_encoder(tokens))
        unet_ms = cuda_ms(lambda: unet(x, t, ctx))
        vae_ms = cuda_ms(lambda: models.vae.decode(z), runs=3)
        enc_ms = cuda_ms(lambda: models.vae.encode(img), runs=3)
        print(f"text_encoder_B{2 * b}_ms={text_ms:.3f} unet_eval_B{2 * b}_ms={unet_ms:.3f} "
              f"vae_decode_B{b}_ms={vae_ms:.3f} vae_encode_B{b}_ms={enc_ms:.3f}")
        wall_ms, device_ms, averages = profiled(lambda: unet(x, t, ctx), PROFILED_EVALS)
    print(f"profiled unet eval: wall_ms={wall_ms:.3f} device_kernel_ms={device_ms:.3f} "
          f"idle_share={1 - device_ms / wall_ms:.3f}")
    write_table(args.out, f"per-op totals over {PROFILED_EVALS} UNet evals (CFG batch {2 * b}, "
                f"{h8}x{w8} latents)", averages)
    del models, unet
    torch.cuda.empty_cache()

    for hw, ci, co in CONV_SITES:
        xs = torch.randn(16, hw, hw, ci, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(co, ci, 3, 3, generator=gen, device="cuda")
             * (9 * ci) ** -0.5).to(torch.bfloat16)
        b = torch.zeros(co, device="cuda")
        u = winograd.transform_weights(w.permute(2, 3, 1, 0)).to(torch.bfloat16).contiguous()
        x_cl = xs.permute(0, 3, 1, 2)             # NCHW view of NHWC memory
        cudnn_ms = cuda_ms(lambda: F.conv2d(x_cl, w, b.to(torch.bfloat16), padding=1))
        wino_ms = cuda_ms(lambda: winograd.conv3x3_winograd(xs, u, b))
        gathered_ms = cuda_ms(lambda: winograd.conv3x3_winograd_gathered(xs, u, b))
        print(f"conv {hw}x{hw} {ci}->{co}: cudnn_direct_ms={cudnn_ms:.4f} "
              f"winograd_kernel_ms={wino_ms:.4f} gathered_kernel_ms={gathered_ms:.4f}")
    print(f"per-op table: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
