"""Chip smoke test of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  0. device details (name, power limit, CUDA, nvcc, triton);
  1. build the ten CUDA sources of the twenty-six kernels from
     minddiffusion_tpu_torch/ops/csrc (K2 and K3 share winograd.cu, K7's
     two variants conv3x3.cu, K10a-d and K11 attn_variants.cu, K12's ten
     modes and bf16s's packed-exp instantiation attn_diag.cu), one nvcc
     each, all at once;
  2. packed-attention kernel (K1) vs its plain version at the main-path
     shapes and every head width (D 40, 64, 80, 160, 512), ragged Nq and
     Nk, beside F.scaled_dot_product_attention on the same tensors (the
     backend PyTorch took named) and K4 at D 512, with the CTAs and waves
     of each launch; then `scripts/ptxas_report.py packed`, whose SASS
     must show wgmma and no mma.sync, and ptxas no spills, in every K1
     kernel;
  3. Winograd conv kernel (K2) vs its plain version at every (shape,
     prologue) of the main path's 21 launches an eval and a ragged case,
     beside cuDNN's F.conv2d, the bound and the TFLOP/s reached;
  4. one full-width SD2 UNet eval, kernel path vs plain path, with K2's
     launches by shape held against phase 3's list;
  5. the main path: SD2 txt2img 512^2, DDIM-50, CFG 9.0, batch 8, bf16,
     seeded random weights, with kernel launch counts;
  6. head-split attention kernel (K4) vs its plain version at the 768x1024
     and 768^2 sites, a ragged, a static-shift and a logit > 88 case,
     beside F.scaled_dot_product_attention;
  7. txt2img 768x1024, DDIM-50, CFG 9.0, batch 4: rerun bytes, s/batch,
     launch counts;
  8. img2img 768^2, strength 0.75, DDIM-50, CFG 9.0, batch 4, launch counts;
  9. txt2img 512^2 with the DPM-Solver++ (2M) sampler, 20 steps, batch 8,
     launch counts;
 10. gathered-tile Winograd kernel (K3) vs its plain version at the phase-3
     shapes, beside its host gather, K2 and cuDNN's F.conv2d on the same
     tensors;
 11. one full-width Wukong-Huahua (SD1) UNet eval, kernel path vs plain path;
 12. path A: Wukong txt2img 512^2, DPM-Solver++ (2M) 15 steps, CFG 7.5,
     batch 4: launch counts, identical bytes on a rerun;
 13. path B: Wukong inpaint 512^2 (9-channel UNet), PLMS-50, CFG 7.5,
     batch 4, under MDT_WINO_TUNE=dma=0 (Winograd sites on K3);
 14. one full-width Taichu-GLIDE base eval (CFG batch 16, 64 px) and one
     super-res eval (batch 8, 256 px), kernel path vs plain path;
 15. the GLIDE cascade (64 px base, 60 ancestral steps, guidance 5.0 ->
     256 px super-res, "fast27" DDIM -> 1024 px SRGAN), batch 8: uint8
     shapes, identical bytes on a rerun, launch counts, s/batch per stage;
 16. the fused sampler tail (K9) vs its plain version and vs the port's own
     unfused super-res step on features caught in a phase-15-sized SR run,
     and in its "sd" mode at the SD2 main-path shape, beside the unfused
     chain (GN+SiLU, cuDNN's conv, the sampler step). No path launches K9
     (the JAX package retired its pipeline hook);
 17. the channel-sums kernel (K6) vs its plain version at the UNet's
     GroupNorm input shapes in both memory orders, beside the two torch
     reductions (no single library call computes both sums); its VJP vs
     autograd through the plain version; and (run
     inside phase 19) vs GroupNorm32's sums on ResBlock inputs of a step;
 18. the fused LN -> GEGLU -> FF kernel (K5) vs its plain version at the SD2
     transformer widths, beside the unfused bf16 chain, and vs the port's
     own `x + ff(norm3(x))` on inputs caught in an SD2 UNet eval. Neither K5
     nor K6 has a path (the JAX package removed their hooks);
 19. SD2 finetune 512^2, batch 3, fp32 master weights / bf16 compute: a
     warm step, 3 timed steps (s/step, img/s, peak memory) with launch
     counts (none in the backward), and the gradient check: the UNet
     gradient of the kernel path within 5e-2 relative L2 of the plain path's,
     and the same check with the gradient bridges taken out, which must fail;
 20. Wukong LoRA through cli/train.py (512^2, batch 3, 3 steps): only the
     adapters move, the adapter checkpoint reloads, the merged model's eps
     agrees; one DreamBooth step through the same CLI;
 21. the implicit-GEMM conv kernel K7, v1 and v2, vs their plain versions at
     bench_conv.py's UNet and VAE shapes, v2 also with its fused GN-affine +
     SiLU prologue and residual, beside cuDNN's conv (the unfused chain for
     the fused case);
 22. the Winograd F(4x4, 3x3) kernel K8 vs its plain version at the UNet's
     32^2 x 640 site and the VAE decoder's shapes, its error against the
     direct conv apart, beside cuDNN's conv; its gradient (direct-conv
     backward) vs autograd through the plain version. No path launches K7
     or K8 (the JAX package has none);
 23. GLIDE training at full width, fp32 master weights / bf16 compute: TG1
     the base at 64 px batch 8, TG2 the super-res at 256 px batch 2 (s/step,
     img/s, peak memory, launches per step, every tensor and the EMA moved),
     and on TG1 the gradient of every UNet and xf param, kernel path vs
     plain path, within 5e-2 relative L2 pooled and tensor by tensor, which
     must fail both ways without the gradient bridges;
 24. the glide_train CLI at its defaults (batch 2): the base 3 steps and
     --super_res 2 steps, {"params", "ema"} checkpoints that reload strictly,
     the base's EMA loaded into the cascade, and the fallback tokens equal in
     two processes;
 25. SD2 serving at the main path's config (512^2, DDIM-50, CFG 9.0, batch
     8) through cli/serve's engine builder with a stated toy tokenizer (the
     CLIP vocab is not in the repository), behind the HTTP front end on a
     thread: 200s with 512^2 PNGs, a co-batched request bytewise equal to
     the same request served alone, launches = batches x (K1 501, K2 1050),
     no synchronising call inside `dispatch`; s/batch and img/s over three
     back-to-back batches, request latency, PNG time, and the device's idle
     gap after each batch (CUDA-only profiler);
 26. GLIDE serving: the engine at batch 8 on the cascade to the SRGAN with
     the placeholder tokens (no sentencepiece model in the repository),
     1024^2 PNGs, row_seeds invariance (co-batched == solo, bytewise),
     launches = batches x (K1 555, K2 1692); then `python -m
     minddiffusion_tpu_torch.cli.serve --family glide` in a subprocess
     answers one request and exits on SIGTERM;
 27. the packed-attention variants K10a (host ones fold), K10b (in-kernel
     fold), K10c (projections fused) and K10d (output projection fused)
     and K11 (K10a's function over its kernel) vs their plain versions at
     the SD2 UNet's ds1 / ds2 shapes and bench_attention.py's, a ragged Nq,
     Nk 77 and Nq + 128, C_out != C, K10d at C 1280 (its 64-row tier),
     both softmax modes; beside SDPA's flash backend or the unfused chain,
     and K1 at the same shape; CTAs (as the launchers report them) and
     waves of each case, K10c's two launches (its projection GEMM, then
     the attention) timed apart, the ones kernels' plan (rows, stages,
     head groups) and device ms (torch.profiler); then
     `scripts/ptxas_report.py attn_variants`, whose SASS must show wgmma
     and no mma.sync in the K10c / K10d kernels and the ones kernel, and
     ptxas no spills in the out and ones kernels. No path of either
     package launches them;
 28. K12, the ten ds1 ablation modes of bench_attn_ds1.py and bf16s with
     the packed bf16 exp, vs their plain versions at its shape (16, 4096,
     320, 5 heads): on independent randn q, k, v and on the script's own
     input x (q = k = v) scaled by 0.75 (every logit below 88) within the
     bf16 tolerance (row by row for the raw exp outputs); on x itself, whose
     diagonal logits pass 88 in ~2% of rows, with the plain version's
     non-finite positions (an output whose finiteness does not move when
     s moves by 2^-16 must match), beside K1 raw-exp at scale 1 and SDPA's
     flash backend at scale 1 (full, kt_full, bf16s, bf16s_ex2), with each
     mode's plan (rows, stages, head groups), CTAs, waves and device ms
     (torch.profiler); then the shootout (`bench/attn_ds1.py`) over every
     variant; then `scripts/ptxas_report.py attn_diag`, whose SASS must show
     wgmma, no mma.sync and ptxas no spills in every `diag_kernel`, and
     K1's and K10d's kernels must keep the registers they had before the
     other modes joined their core;
 29. the eval path at full width: CLIPScoreConfig.vit_h14 (ViT-H/14 and
     the 24-layer text tower, fp32, seeded random weights) scores phase 5's
     8 images against their tokens (finite, within [-100, 100], identical
     on a rerun), CLIP-FID between the batch's halves (finite, >= 0), the
     time per image;
 30. export at full width: SD2's random weights through
     `cli/export_weights` to .safetensors and back through `cli.common.
     build_sd`; one UNet eval bitwise equal before and after, and
     `cli/serve.check_ckpt` takes the file.
Phases 2 and 6 also hold K1 and K4 at the SD1 head widths (D 40, 80, 160);
phase 2 holds K1 at GLIDE's sites, whose 128 text keys precede the spatial
ones (Nk = Nq + 128).
The library calls are timing yardsticks only; the port never calls them.
K5-K12 have no path: their JSON rows report launches 0 and `held_in_phase`.
Each path runs with the launch counters set to 0 just before it and read
just after, held against counts derived by hand from the SD2 and SD1
configs (for training: per step). The line before the last is the kernel table as JSON; the last
line is the device record. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

REL_TOL = 2e-2          # bf16 tolerance, relative to max |reference|
WARMUP, RUNS = 2, 7
KERNELS = ("packed_attention", "winograd", "flash_attention", "winograd_gathered",
           "glide_tail", "channel_sums", "fused_ff", "conv3x3_v1", "conv3x3_gemm",
           "winograd43", "attn_ones", "attn_fold", "attn_proj", "attn_out",
           "ones_attention", "diag_qk", "diag_exp", "diag_nosm", "diag_fp32pv", "diag_full",
           "diag_kt_qk", "diag_kt_full", "diag_qk_slice", "diag_qkexp_slice", "diag_bf16s",
           "diag_bf16s_ex2")
# csrc/<name>.cu; K2 and K3 share one, K7's two variants another, K10a-d and
# K11 attn_variants.cu, K12's modes attn_diag.cu
SOURCES = ("packed_attention", "winograd", "flash_attention", "glide_tail", "gn_stats",
           "fused_ff", "conv3x3", "winograd43", "attn_variants", "attn_diag")
# The bounds take the H100 peaks of bench/attn_ds1.py (PEAK_BF16, PEAK_BYTES,
# MUFU_PER_CLOCK); the exp rate at the card's max SM clock, which phase 0
# reads from nvidia-smi
CARD = {"exp_per_s": None, "smi": None}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Median CUDA-event time of `fn` in ms, after warm-up."""
    for _ in range(WARMUP):
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


def device_ms(fn, kernel: str, runs: int = 10) -> "float | None":
    """Mean device time in ms of a launch of the kernel named `kernel` that
    `fn` makes once a call, by torch.profiler (CUDA activity only) over
    `runs` calls; None where the profiler recorded none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # the mean over the launches it recorded: a session may drop some
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in evs)
    count = sum(e.count for e in evs)
    return total / count / 1000.0 if count else None


def fmt_ms(ms: "float | None") -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def errors(got: torch.Tensor, ref: torch.Tensor) -> "tuple[float, float]":
    """(max abs error, max abs error relative to max |ref|)."""
    abs_err = (got.float() - ref.float()).abs().max().item()
    return abs_err, abs_err / ref.float().abs().max().item()


def bound(flops: float, nbytes: float) -> "tuple[float, str]":
    """(least ms the card could take, what bounds it): the larger of the
    bf16 tensor-core time of the products and the HBM time of reading each
    input once and writing each output once."""
    from minddiffusion_tpu_torch.bench import attn_ds1

    ms, by, _ = attn_ds1.work_bound(flops, 0.0, 0.0, nbytes, CARD["exp_per_s"])
    return ms, by


def attention_bound(b: int, heads: int, nq: int, nk: int, d: int,
                    proj_flops: float = 0.0, nbytes: "float | None" = None):
    """(ms, "operations" or "bytes", the term that bounds: "mma", "exp" or
    "bytes"): `attn_ds1.work_bound` of attention (`attn_ds1.attention_work`:
    QK^T and PV, one fp32 exp per score, q, k, v read and out written in
    bf16), with `proj_flops` more bf16 flops and `nbytes` in place of its
    bytes where given."""
    from minddiffusion_tpu_torch.bench import attn_ds1

    flops, tf32, exps, nb = attn_ds1.attention_work(b, heads, nq, nk, d)
    return attn_ds1.work_bound(flops + proj_flops, tf32, exps, nb if nbytes is None else nbytes,
                               CARD["exp_per_s"])


def sdpa_ms(q, k, v, scale: float) -> "tuple[float, str]":
    """F.scaled_dot_product_attention on (B, H, N, D) views of the kernel's
    inputs: the ms of PyTorch's default choice and the backend it took (the
    first that runs, in the dispatcher's order)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why each refused backend was refused
                F.scaled_dot_product_attention(q, k, v, scale=scale)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                           runs=5), name.lower()
    raise RuntimeError("no SDPA backend ran")


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return proc.stdout.strip()


def phase0() -> str:
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    from minddiffusion_tpu_torch.ops import _build

    nvcc_line = run([_build.nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    max_sm_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"]).splitlines()[0])
    from minddiffusion_tpu_torch.bench import attn_ds1

    CARD["exp_per_s"] = attn_ds1.MUFU_PER_CLOCK * max_sm_mhz * 1e6
    CARD["smi"] = smi
    log(f"[phase 0] device={name} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc='{nvcc_line}' triton={triton_version} "
        f"max_sm_clock_mhz={max_sm_mhz:.0f} exp_per_s={CARD['exp_per_s']:.4g}")
    log(smi)
    return name


def phase1() -> None:
    from minddiffusion_tpu_torch.ops import _build

    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    log(f"[phase 1] built {', '.join(SOURCES)} in {time.time() - t0:.2f} s")


ATTN_CASES = [  # (label, B, N, C, heads, exact, q multiplier)
    ("unet_64x64_self", 16, 4096, 320, 5, False, 1.0),
    ("unet_32x32_self", 16, 1024, 640, 10, False, 1.0),
    ("unet_ds1_768x768", 8, 9216, 320, 5, False, 1.0),
    ("vae_mid_attn", 8, 4096, 512, 1, True, 1.0),
    ("exact_logits_gt_88", 2, 1024, 320, 5, True, 40.0),
    # SD1 (8 heads): D 40 at ds1, 80 at ds2 of 512^2, 160 at ds4 of 1024^2
    ("wukong_ds1_512", 8, 4096, 320, 8, True, 1.0),
    ("wukong_ds2_512", 8, 1024, 640, 8, True, 1.0),
    ("wukong_ds4_1024", 8, 1024, 1280, 8, True, 1.0),
    ("exact_logits_gt_88_d40", 2, 1024, 320, 8, True, 40.0),
    # D 64 in the same mode on the same grid (B8, 8 heads, exact), so the
    # SD1 widths are compared per flop with D 64 within one run
    ("d64_exact_4096_h8", 8, 4096, 512, 8, True, 1.0),
    ("d64_exact_1024_h8", 8, 1024, 512, 8, True, 1.0),
]
GLIDE_ATTN_CASES = [  # (label, B, Nq, Nk, C, heads): exact, 128 text keys first
    ("glide_base_ds2", 16, 1024, 1152, 384, 6),     # 32^2 of the 64 px base, CFG batch
    ("glide_sr_ds8", 8, 1024, 1152, 384, 6),        # 32^2 of the 256 px super-res
    # the 16^2 tier that MDT_GLIDE_TUNE=attn_route=256 sends to K1
    ("glide_sr_ds16_attn_route_256", 8, 256, 384, 768, 12),
    # ragged Nq and Nk (no path has them; the kernel takes any Nq, Nk >= 1)
    ("ragged_nq1000_nk77", 2, 1000, 77, 320, 5),
    ("ragged_d512_nq1000_nk77", 2, 1000, 77, 512, 1),
]
# The kernels of packed_attention.cu, whose SASS must hold wgmma (HGMMA),
# no mma.sync (HMMA) and whose ptxas report no spills
K1_KERNELS = ("packed_attn_kernel", "packed_attn512_kernel")


def phase2(gen: torch.Generator, table: dict) -> None:
    """K1 against its plain version at every case, beside SDPA (the backend
    PyTorch takes at each head width named), K4 on the same tensors at D 512
    (the VAE mid's other kernel), the bound, and the CTAs and waves (one CTA
    an SM) as the C entry reports them; then the SASS and spills of its
    kernels."""
    from minddiffusion_tpu_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = ([(label, b, n, n, c, heads, exact, qmul)
              for label, b, n, c, heads, exact, qmul in ATTN_CASES]
             + [(label, b, nq, nk, c, heads, True, 1.0)
                for label, b, nq, nk, c, heads in GLIDE_ATTN_CASES])
    for label, b, n, nk, c, heads, exact, qmul in cases:
        q, k, v = (torch.randn(b, m, c, generator=gen, device="cuda")
                   .to(torch.bfloat16) for m in (n, nk, nk))
        q = (q.float() * qmul).to(torch.bfloat16)
        scale = (c // heads) ** -0.5
        ref = fa.packed_attention_plain(q, k, v, heads, scale, exact)
        fa.last_ctas.clear()
        got = fa.flash_attention_packed(q, k, v, heads, scale, exact)
        torch.cuda.synchronize()
        ctas = fa.last_ctas["mdt_packed_attention"]
        rows, key_tile, stages, groups = fa.packed_plan(n, c, heads, b, sms)
        max_logit = None
        if qmul != 1.0:
            d = c // heads
            s = torch.matmul((q[0, :, :d].float() * scale),
                             k[0, :, :d].float().T)
            max_logit = s.max().item()
            assert max_logit > 88, max_logit
        abs_err, err = errors(got, ref)
        assert torch.isfinite(got.float()).all(), label
        ms = cuda_ms(lambda: fa.flash_attention_packed(q, k, v, heads, scale, exact))
        plain_ms = cuda_ms(lambda: fa.packed_attention_plain(q, k, v, heads, scale, exact),
                           runs=5)
        d = c // heads
        heads_view = [t.view(b, -1, heads, d).transpose(1, 2) for t in (q, k, v)]
        library_ms, backend = sdpa_ms(*heads_view, scale)
        k4_ms = None
        if d == 512:   # the VAE mid's yardstick: K4 on (B, N, H, D) views, no copy
            split = [t.view(b, -1, heads, d) for t in (q, k, v)]
            k4_ms = cuda_ms(lambda: fa.flash_attention(*split, scale, exact))
        bound_ms, bound_by, term = attention_bound(b, heads, n, nk, d)
        log(f"[phase 2] attn {label} B={b} Nq={n} Nk={nk} C={c} heads={heads} D={d} "
            f"exact={exact} max_abs_err={abs_err:.3e} rel_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} sdpa_backend={backend} "
            + (f"k4_ms={k4_ms:.4f} " if k4_ms is not None else "")
            + f"bound_ms={bound_ms:.4f} ({term}) rows={rows} key_tile={key_tile} "
            f"stages={stages} groups={groups} ctas={ctas} waves={ctas / sms:.2f}"
            + (f" max_logit={max_logit:.1f}" if max_logit else ""))
        assert err <= REL_TOL, (label, err)
        table["packed_attention"]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by=bound_by, bound_term=term, sdpa_backend=backend, k4_ms=k4_ms,
                 ctas=ctas, waves=ctas / sms))
    hold_wgmma_sass("packed_attention", K1_KERNELS, "phase 2", spills=True)


# Every (shape, prologue) of the 21 K2 launches of an SD2 UNet eval at
# 512^2 (CFG batch 16), with its launches per eval (phase 4 holds the list
# against the launches it logs), and one ragged case: P 192 is no multiple of
# the fused kernel's 128 tiles, nor C_out 768 + C_in 576 of its 64 channels.
WINO_CASES = [  # (label, B, H, W, C_in, C_out, prologue, launches per SD2 eval)
    ("32x32_640_gn", 16, 32, 32, 640, 640, True, 6),
    ("16x16_640to1280_gn", 16, 16, 16, 640, 1280, True, 1),
    ("16x16_1280_gn", 16, 16, 16, 1280, 1280, True, 6),
    ("16x16_1280_plain", 16, 16, 16, 1280, 1280, False, 1),
    ("16x16_2560_gn", 16, 16, 16, 2560, 1280, True, 2),
    ("16x16_1920_gn", 16, 16, 16, 1920, 1280, True, 1),
    ("32x32_1280_plain", 16, 32, 32, 1280, 1280, False, 1),
    ("32x32_1920to640_gn", 16, 32, 32, 1920, 640, True, 1),
    ("32x32_1280to640_gn", 16, 32, 32, 1280, 640, True, 1),
    ("32x32_960to640_gn", 16, 32, 32, 960, 640, True, 1),
    ("ragged_b3_16x16_576to768_gn", 3, 16, 16, 576, 768, True, 0),
]
# The case the JSON line reports per kernel: K2's is the one without the
# GN+SiLU prologue, where one cuDNN call computes the same function.
MAIN_CASE = {"packed_attention": "unet_64x64_self", "winograd": "32x32_1280_plain",
             "flash_attention": "unet_ds1_768x1024", "winograd_gathered": "32x32_1280_plain",
             "glide_tail": "glide_sr_256", "channel_sums": "16x64x64x320_bhwc",
             "fused_ff": "ds1_16x4096x320", "conv3x3_v1": "unet_32x32_640",
             "conv3x3_gemm": "unet_32x32_640", "winograd43": "vae_512x512_128",
             "attn_ones": "ds1_16x4096x320", "attn_fold": "ds1_16x4096x320",
             "attn_proj": "ds1_16x4096x320", "attn_out": "ds1_16x4096x320",
             "ones_attention": "ds1_16x4096x320",
             **{name: "ds1_16x4096x320" for name in KERNELS if name.startswith("diag_")}}


def wino_operands(gen: torch.Generator, b: int, h: int, w: int, ci: int, co: int, gn: bool):
    """x, the HWIO kernel, U, bias and the prologue's mult / add (or None)."""
    from minddiffusion_tpu_torch.ops import winograd as wg

    x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
    kern = torch.randn(3, 3, ci, co, generator=gen, device="cuda") * (9 * ci) ** -0.5
    u = wg.transform_weights(kern).to(torch.bfloat16).contiguous()
    bias = torch.randn(co, generator=gen, device="cuda") * 0.1
    mult = add = None
    if gn:
        mult = 1.0 + 0.1 * torch.randn(b, ci, generator=gen, device="cuda")
        add = 0.1 * torch.randn(b, ci, generator=gen, device="cuda")
    return x, kern, u, bias, mult, add


def wino_library_ms(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> float:
    """cuDNN's conv on the NCHW view of the same NHWC memory (conv only: no
    library call takes the GN+SiLU prologue)."""
    x_cl, w_oihw = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).to(torch.bfloat16)
    bias_bf16 = bias.to(torch.bfloat16)
    return cuda_ms(lambda: F.conv2d(x_cl, w_oihw, bias_bf16, padding=1))


def wino_work(b: int, h: int, w: int, ci: int, co: int, gn: bool) -> "tuple[float, float]":
    """(flops of the 16 Winograd products, bytes of x, U, bias, the prologue's
    mult / add and y, each once)."""
    p = b * (h // 2) * (w // 2)
    return (2.0 * 16 * p * ci * co,
            2.0 * b * h * w * (ci + co) + 2.0 * 16 * ci * co + 4.0 * co
            + (8.0 * b * ci if gn else 0.0))


def phase3(gen: torch.Generator, table: dict) -> None:
    from minddiffusion_tpu_torch.ops import winograd as wg

    for label, b, h, w, ci, co, gn, per_eval in WINO_CASES:
        x, kern, u, bias, mult, add = wino_operands(gen, b, h, w, ci, co, gn)
        ref = wg.winograd_plain(x, u, bias, mult, add)
        got = wg.conv3x3_winograd(x, u, bias, mult, add)
        torch.cuda.synchronize()
        abs_err, err = errors(got, ref)
        assert torch.isfinite(got.float()).all(), label
        ms = cuda_ms(lambda: wg.conv3x3_winograd(x, u, bias, mult, add))
        plain_ms = cuda_ms(lambda: wg.winograd_plain(x, u, bias, mult, add), runs=5)
        library_ms = wino_library_ms(x, kern, bias)
        flops, nbytes = wino_work(b, h, w, ci, co, gn)
        bound_ms, bound_by = bound(flops, nbytes)
        tflops = flops / ms / 1e9
        log(f"[phase 3] wino {label} B={b} {h}x{w} {ci}->{co} prologue={gn} "
            f"per_eval={per_eval} max_abs_err={abs_err:.3e} rel_err={err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} cudnn_conv_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={tflops:.1f}")
        assert err <= REL_TOL, (label, err)
        table["winograd"]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by=bound_by, tflops=tflops, per_eval=per_eval))


def wrappers() -> dict:
    """The launch-counting wrapper of each kernel."""
    from minddiffusion_tpu_torch.ops import flash_attention as fa, glide_tail, winograd as wg

    from minddiffusion_tpu_torch.ops import attn_diag as ad, attn_variants as av, conv3x3
    from minddiffusion_tpu_torch.ops import fused_ff, gn_stats, winograd43

    return {"packed_attention": fa.flash_attention_packed,
            "winograd": wg.conv3x3_winograd, "flash_attention": fa.flash_attention,
            "winograd_gathered": wg.conv3x3_winograd_gathered,
            "glide_tail": glide_tail.tail_step, "channel_sums": gn_stats.channel_sums,
            "fused_ff": fused_ff.fused_ln_geglu_ff, "conv3x3_v1": conv3x3.conv3x3_pallas,
            "conv3x3_gemm": conv3x3.conv3x3_gemm,
            "winograd43": winograd43.conv3x3_winograd43,
            "attn_ones": av.flash_attention_packed_ones,
            "attn_fold": av.flash_attention_packed_fold,
            "attn_proj": av.flash_attention_packed_proj,
            "attn_out": av.flash_attention_packed_out, "ones_attention": av.ones_attention,
            **{name: getattr(ad, fn) for name, (fn, _) in DIAG_ROWS.items()}}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


# Kernel launches the SD2 architecture implies at 64x64 latents (512^2
# images), counted by hand from UNetConfig.sd2 and VAEConfig, not from the
# port's gates. Per UNet eval: K1 at the 5 self-attentions at 64^2 (4096
# tokens) and the 5 at 32^2 (1024); the 16^2 (256 tokens) and 8^2 ones are
# below the 1024-token gate, and cross-attention has 77 keys. K2 at the 21
# stride-1 3x3 convs with C_in >= 512 at 32^2 and 16^2: input side 3 at 32^2
# and 4 at 16^2, output side 6 at 16^2 and 6 at 32^2, and the two Upsample
# convs that land at 16^2 and 32^2. The VAE decode adds one K1 launch (its
# mid attention at 64^2); its convs run at 64^2 and above, outside the gate.
PER_UNET_EVAL = {k: {"packed_attention": 10, "winograd": 21}.get(k, 0) for k in KERNELS}
PER_DECODE = {k: {"packed_attention": 1}.get(k, 0) for k in KERNELS}


def sd2_models(gen: torch.Generator):
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    return SDModels.create(family="sd2", dtype=torch.bfloat16, attn_impl="fast",
                           device="cuda", generator=gen)


def winograd_histogram(fn) -> dict:
    """K2's launches in `fn()` by (B, H, W, C_in, C_out, prologue): the
    layers reach the wrapper through its module, so a recording stand-in is
    put there for the call (carrying the launch count, which the wrapper
    adds to under its module name)."""
    from minddiffusion_tpu_torch.ops import winograd as wg

    hist: dict = {}
    kernel = wg.conv3x3_winograd

    def recording(x, u, bias, gn_mult=None, gn_add=None):
        key = (*x.shape, u.shape[-1], gn_mult is not None)
        hist[key] = hist.get(key, 0) + 1
        return kernel(x, u, bias, gn_mult, gn_add)

    recording.launches = kernel.launches
    wg.conv3x3_winograd = recording
    try:
        fn()
    finally:
        wg.conv3x3_winograd = kernel
        kernel.launches = recording.launches
    return hist


def phase4(gen: torch.Generator) -> None:
    """One full-width SD2 UNet eval (CFG batch 16, 64x64 latents, bf16,
    random weights with no zero-init) on the kernel path vs the plain path."""
    from minddiffusion_tpu_torch import ops

    models = sd2_models(gen)
    unet = models.unet
    b, h8 = 16, 64
    x = torch.randn(b, h8, h8, 4, generator=gen, device="cuda")
    t = torch.linspace(1, 981, b, device="cuda").round().long()
    ctx = torch.randn(b, 77, 1024, generator=gen, device="cuda")
    with torch.inference_mode(), unet.hoisted_winograd():
        reset_counts()
        eps_k = unet(x, t, ctx)
        counts = read_counts()
        with ops.plain_reference():
            eps_p = unet(x, t, ctx)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: unet(x, t, ctx), runs=5)
        with ops.plain_reference():
            plain_ms = cuda_ms(lambda: unet(x, t, ctx), runs=5)
        hist = winograd_histogram(lambda: unet(x, t, ctx))
    assert counts == PER_UNET_EVAL, (counts, PER_UNET_EVAL)
    expected_hist = {(b, h, w, ci, co, gn): n
                     for _, b, h, w, ci, co, gn, n in WINO_CASES if n}
    log(f"[phase 4] K2 launches by (B, H, W, C_in, C_out, prologue): {dict(hist)}")
    assert hist == expected_hist, (hist, expected_hist)
    assert torch.isfinite(eps_k).all() and eps_k.shape == (b, h8, h8, 4)
    rel_l2 = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    log(f"[phase 4] unet sd2 B={b} 64x64 bf16 launches={counts} "
        f"rel_l2={rel_l2:.3e} eps_rms={eps_p.pow(2).mean().sqrt().item():.4f} "
        f"kernel_path_ms={ms:.3f} plain_path_ms={plain_ms:.3f}")
    assert rel_l2 <= REL_TOL, rel_l2
    del models, unet
    torch.cuda.empty_cache()


def phase5() -> "tuple[dict, float, torch.Tensor]":
    """The main path: txt2img SD2 512^2, DDIM-50, CFG 9.0, batch 8, bf16.
    Returns the launch counts, the seconds of the second run and the images
    (on the host)."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    batch, size, steps = 8, 512, 50
    torch.cuda.reset_peak_memory_stats()
    models = sd2_models(torch.Generator(device="cuda").manual_seed(1))
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=size, width=size, num_steps=steps, sampler="ddim",
        guidance_scale=9.0, batch_size=batch)
    tokens = torch.ones(batch, 77, dtype=torch.long)
    uncond = torch.zeros(batch, 77, dtype=torch.long)
    expected = {k: PER_UNET_EVAL[k] * steps + PER_DECODE[k] for k in PER_UNET_EVAL}

    def run():
        t0 = time.time()
        img = fn(models, tokens, uncond, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        return img, time.time() - t0

    reset_counts()
    img1, first_s = run()
    counts = read_counts()
    img2, batch_s = run()
    assert counts == expected, (counts, expected)
    assert img1.shape == (batch, size, size, 3) and img1.dtype == torch.uint8
    assert torch.equal(img1, img2), "same generator seed gave different images"
    assert img1.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 5] txt2img sd2 512x512 ddim-50 cfg=9.0 B={batch} bf16 "
        f"launches={counts} expected={expected} first_run_s={first_s:.3f} "
        f"s_per_batch={batch_s:.3f} img_per_s={batch / batch_s:.4f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return counts, batch_s, img1.cpu()


FLASH_CASES = [  # (label, B, Nq, Nk, heads, D, exact, q multiplier)
    ("unet_ds1_768x1024", 8, 12288, 12288, 5, 64, True, 1.0),
    ("vae_mid_768x1024", 4, 12288, 12288, 1, 512, True, 1.0),
    ("vae_mid_768x768", 4, 9216, 9216, 1, 512, True, 1.0),
    # the sites where K1 runs today, for the route's re-derivation (S4)
    ("unet_ds1_768x768", 8, 9216, 9216, 5, 64, True, 1.0),
    ("vae_mid_512x512", 8, 4096, 4096, 1, 512, True, 1.0),
    ("ragged_300x640_d64", 2, 300, 640, 5, 64, True, 1.0),
    ("ragged_300x640_d512", 2, 300, 640, 1, 512, True, 1.0),
    ("shift20_4096_d64", 2, 4096, 4096, 5, 64, False, 1.0),
    ("exact_logits_gt_88", 2, 1024, 1024, 5, 64, True, 40.0),
    # SD1 (8 heads): the 1024^2 ds1 site (16384 tokens, D 40), ragged cases
    ("wukong_ds1_1024", 8, 16384, 16384, 8, 40, True, 1.0),
    ("ragged_300x640_d40", 2, 300, 640, 8, 40, True, 1.0),
    ("ragged_300x640_d80", 2, 300, 640, 8, 80, True, 1.0),
    ("ragged_300x640_d160", 2, 300, 640, 8, 160, True, 1.0),
]


def phase6(gen: torch.Generator, table: dict) -> None:
    from minddiffusion_tpu_torch.ops import flash_attention as fa

    for label, b, nq, nk, heads, d, exact, qmul in FLASH_CASES:
        q, k, v = (torch.randn(b, n, heads, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (nq, nk, nk))
        q = (q.float() * qmul).to(torch.bfloat16)
        scale = d ** -0.5
        ref = fa.flash_attention_plain(q, k, v, scale, exact)
        got = fa.flash_attention(q, k, v, scale, exact)
        torch.cuda.synchronize()
        max_logit = None
        if qmul != 1.0:
            s = torch.matmul(q[0, :, 0].float() * scale, k[0, :, 0].float().T)
            max_logit = s.max().item()
            assert max_logit > 88, max_logit
        abs_err, err = errors(got, ref)
        assert torch.isfinite(got.float()).all(), label
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale, exact))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale, exact), runs=3)
        heads_view = [t.transpose(1, 2) for t in (q, k, v)]
        library_ms, backend = sdpa_ms(*heads_view, scale)
        bound_ms, bound_by, term = attention_bound(b, heads, nq, nk, d)
        log(f"[phase 6] flash {label} B={b} Nq={nq} Nk={nk} heads={heads} D={d} "
            f"exact={exact} max_abs_err={abs_err:.3e} rel_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} sdpa_backend={backend} "
            f"bound_ms={bound_ms:.4f} ({term})"
            + (f" max_logit={max_logit:.1f}" if max_logit else ""))
        assert err <= REL_TOL, (label, err)
        table["flash_attention"]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bound_term=term))
        del q, k, v, ref, got
    torch.cuda.empty_cache()


# Launches of the slice's paths, counted by hand from UNetConfig.sd2 and
# VAEConfig (not from the port's gates). A UNet eval has 5 self-attentions
# at each of ds 1, 2 and 4. Its stride-1 3x3 convs with C_in >= 512 are
# Winograd-gated while the latent level's min(H, W) is in [12, 48]: the 21
# at ds 2 and 4 (as at 512^2), and at 768-class sizes also the 14 at ds8
# (12x16 at 768x1024, 12x12 at 768^2: 4 in the input blocks, 4 in the
# middle block, 6 in the output blocks), 35 in all. The attention kernel of
# a site follows the reference's route: at 768x1024 (96x128 latents) ds1 has
# 12288 tokens, whose K/V footprint (12288 * 320 * 4 B + 128 * 320 * 6 B)
# exceeds 12 MiB -> K4, ds2 has 3072 -> K1, ds4 has 768 (< 1024) -> einsum;
# the VAE mid attention (512 channels, one head, 12288 tokens) -> K4. At
# 768^2 (96x96) ds1 has 9216 tokens, footprint 12,042,240 B <= 12 MiB -> K1,
# ds2 2304 -> K1; the VAE mid attention of the encoder and of the decoder
# (9216 tokens) -> K4. The VAE's convs run at 96 px and above, outside the
# Winograd gate.
#
# The Wukong-Huahua paths (UNetConfig.sd1: the SD2 channel plan with 8 heads,
# so head dims 40 / 80 / 160) have the same sites at 512^2: 10 self-
# attentions at ds 1 and 2 per eval (ds1 4096 tokens x C 320, footprint
# 5,734,400 B -> K1; ds2 1024 x 640 -> K1), 21 gated 3x3 convs per eval,
# and one K1 per VAE call (encoder or decoder mid attention, 4096 tokens).
# Path B sets MDT_WINO_TUNE=dma=0, so its 21 convs per eval take K3, not K2.
PATHS = {
    # name: (per UNet eval, per VAE encode + decode, UNet evals)
    "txt2img_768x1024_ddim50_b4": (
        {"packed_attention": 5, "winograd": 35, "flash_attention": 5},
        {"packed_attention": 0, "winograd": 0, "flash_attention": 1}, 50),
    # img2img strength 0.75 of DDIM-50 runs int(0.75 * 50) = 37 steps
    "img2img_768_s075_ddim50_b4": (
        {"packed_attention": 10, "winograd": 35, "flash_attention": 0},
        {"packed_attention": 0, "winograd": 0, "flash_attention": 2}, 37),
    # DPM-Solver++ 2M, 20 steps: one UNet eval per step (the first at t = T,
    # none after the last update)
    "txt2img_512_dpm20_b8": (PER_UNET_EVAL, PER_DECODE, 20),
    # path A: DPM-Solver++ 2M, 15 steps, decode only
    "wukong_txt2img_512_dpm15_b4": (PER_UNET_EVAL, PER_DECODE, 15),
    # path B: PLMS-50 runs 51 evals (the Euler bootstrap's second eval);
    # the masked image is encoded and the result decoded
    "wukong_inpaint_512_plms50_b4_dma0": (
        {"packed_attention": 10, "winograd": 0, "flash_attention": 0,
         "winograd_gathered": 21},
        {"packed_attention": 2, "winograd": 0, "flash_attention": 0,
         "winograd_gathered": 0}, 51),
    # Training at 512^2 (phases 19, 20): a step runs one UNet forward per
    # loss (two for DreamBooth: train and reg) and one VAE encode per loss
    # (its mid attention, K1); the backward recomputes einsum attention and
    # the direct conv, so it launches no kernel. Per step: K1 11, K2 21; a
    # DreamBooth step K1 22, K2 42.
    "sd2_finetune_512_b3": (PER_UNET_EVAL, PER_DECODE, 1),
    "wukong_lora_512_b3_3steps": (PER_UNET_EVAL, {"packed_attention": 3}, 3),
    "wukong_dreambooth_512_b3_1step": (PER_UNET_EVAL, {"packed_attention": 2}, 2),
}


def expected_counts(path: str) -> dict:
    per_eval, per_vae, evals = PATHS[path]
    return {k: per_eval.get(k, 0) * evals + per_vae.get(k, 0) for k in KERNELS}


def timed(fn) -> "tuple[torch.Tensor, float]":
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase7(models) -> dict:
    """txt2img 768x1024 (H 768, W 1024), DDIM-50, CFG 9.0, batch 4."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    path, batch, height, width = "txt2img_768x1024_ddim50_b4", 4, 768, 1024
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=height, width=width, num_steps=50, sampler="ddim",
        guidance_scale=9.0, batch_size=batch)
    tokens = torch.ones(batch, 77, dtype=torch.long)
    uncond = torch.zeros(batch, 77, dtype=torch.long)
    run = lambda: fn(models, tokens, uncond,  # noqa: E731
                     torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    img1, first_s = timed(run)
    counts = read_counts()
    img2, batch_s = timed(run)
    expected = expected_counts(path)
    assert counts == expected, (path, counts, expected)
    assert img1.shape == (batch, height, width, 3) and img1.dtype == torch.uint8
    assert torch.equal(img1, img2), "same generator seed gave different images"
    assert img1.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 7] {path} launches={counts} expected={expected} "
        f"first_run_s={first_s:.3f} s_per_batch={batch_s:.3f} "
        f"img_per_s={batch / batch_s:.4f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return counts


def phase8(models) -> dict:
    """img2img 768^2, strength 0.75, DDIM-50, CFG 9.0, batch 4."""
    from minddiffusion_tpu_torch.core import latents
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    path, batch, size = "img2img_768_s075_ddim50_b4", 4, 768
    fn = StableDiffusionPipeline(models).build_img2img(
        height=size, width=size, num_steps=50, strength=0.75, guidance_scale=9.0)
    # a smooth colour field with noise on it, in [-1, 1]
    ramp = torch.linspace(-1, 1, size, device="cuda")
    init = torch.stack([ramp[None, :].expand(size, size), ramp[:, None].expand(size, size),
                        torch.outer(ramp, ramp)], dim=-1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    init = (0.8 * init + 0.2 * torch.randn(size, size, 3, generator=gen, device="cuda"))
    init = init.clamp(-1, 1)[None].repeat(batch, 1, 1, 1)
    tokens = torch.ones(batch, 77, dtype=torch.long)
    uncond = torch.zeros(batch, 77, dtype=torch.long)
    reset_counts()
    img, batch_s = timed(lambda: fn(models, init, tokens, uncond,
                                    torch.Generator(device="cuda").manual_seed(8)))
    counts = read_counts()
    expected = expected_counts(path)
    assert counts == expected, (path, counts, expected)
    assert img.shape == (batch, size, size, 3) and img.dtype == torch.uint8
    init_u8 = latents.unit_range_to_uint8(init)
    moved = (img.float() - init_u8.float()).abs().mean().item()
    assert moved > 5.0, f"output too close to the init image ({moved:.2f})"
    assert img.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 8] {path} launches={counts} expected={expected} "
        f"s_per_batch={batch_s:.3f} mean_abs_change_vs_init={moved:.2f}")
    return counts


def phase9(models) -> dict:
    """txt2img 512^2 with DPM-Solver++ 2M, 20 steps, CFG 9.0, batch 8."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    path, batch, size = "txt2img_512_dpm20_b8", 8, 512
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=size, width=size, num_steps=20, sampler="dpm",
        guidance_scale=9.0, batch_size=batch)
    tokens = torch.ones(batch, 77, dtype=torch.long)
    uncond = torch.zeros(batch, 77, dtype=torch.long)
    reset_counts()
    img, batch_s = timed(lambda: fn(models, tokens, uncond,
                                    torch.Generator(device="cuda").manual_seed(9)))
    counts = read_counts()
    expected = expected_counts(path)
    assert counts == expected, (path, counts, expected)
    assert img.shape == (batch, size, size, 3) and img.dtype == torch.uint8
    assert img.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 9] {path} launches={counts} expected={expected} "
        f"s_per_batch={batch_s:.3f}")
    return counts


def phase10(gen: torch.Generator, table: dict) -> None:
    """K3 (gathered tiles; GN+SiLU applied on the host) at the phase-3
    shapes, beside K2 and cuDNN's conv on the same tensors."""
    from minddiffusion_tpu_torch.ops import winograd as wg

    for label, b, h, w, ci, co, gn, _ in WINO_CASES:
        x, kern, u, bias, mult, add = wino_operands(gen, b, h, w, ci, co, gn)
        ref = wg.winograd_gathered_plain(x, u, bias, mult, add)
        got = wg.conv3x3_winograd_gathered(x, u, bias, mult, add)
        k2 = wg.conv3x3_winograd(x, u, bias, mult, add)
        torch.cuda.synchronize()
        abs_err, err = errors(got, ref)
        _, err_k2 = errors(got, k2)
        assert torch.isfinite(got.float()).all(), label
        ms = cuda_ms(lambda: wg.conv3x3_winograd_gathered(x, u, bias, mult, add))
        gather_ms = cuda_ms(lambda: wg.gather_tiles(x, mult, add))
        plain_ms = cuda_ms(lambda: wg.winograd_gathered_plain(x, u, bias, mult, add), runs=5)
        k2_ms = cuda_ms(lambda: wg.conv3x3_winograd(x, u, bias, mult, add))
        library_ms = wino_library_ms(x, kern, bias)
        flops, nbytes = wino_work(b, h, w, ci, co, gn)
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"[phase 10] wino_gathered {label} B={b} {h}x{w} {ci}->{co} host_gn={gn} "
            f"max_abs_err={abs_err:.3e} rel_err={err:.3e} rel_err_vs_k2={err_k2:.3e} "
            f"kernel_ms={ms:.4f} gather_ms={gather_ms:.4f} plain_ms={plain_ms:.4f} "
            f"k2_ms={k2_ms:.4f} cudnn_conv_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) tflops={flops / ms / 1e9:.1f}")
        assert err <= REL_TOL and err_k2 <= REL_TOL, (label, err, err_k2)
        table["winograd_gathered"]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                 gather_ms=gather_ms, k2_ms=k2_ms, library_ms=library_ms,
                 bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9))


def zh_tokens(batch: int, fill) -> torch.Tensor:
    """Wordpiece-shaped ids: [CLS], seven copies of `fill` (none for the
    empty prompt), [SEP], zero padding to 77."""
    row = [101] + ([fill] * 7 if fill is not None else []) + [102]
    ids = torch.zeros(batch, 77, dtype=torch.long)
    ids[:, :len(row)] = torch.tensor(row)
    return ids


def wukong_models(family: str, gen: torch.Generator):
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    return SDModels.create(family=family, dtype=torch.bfloat16, attn_impl=None,
                           device="cuda", generator=gen)


def phase11(gen: torch.Generator) -> None:
    """One full-width SD1 (Wukong-Huahua) UNet eval: CFG batch 8, 64x64
    latents, context 768, exact softmax; kernel path vs plain path."""
    from minddiffusion_tpu_torch import ops

    models = wukong_models("wukong", gen)
    unet = models.unet
    b, h8 = 8, 64
    x = torch.randn(b, h8, h8, 4, generator=gen, device="cuda")
    t = torch.linspace(1, 981, b, device="cuda").round().long()
    ctx = torch.randn(b, 77, 768, generator=gen, device="cuda")
    with torch.inference_mode(), unet.hoisted_winograd():
        reset_counts()
        eps_k = unet(x, t, ctx)
        counts = read_counts()
        with ops.plain_reference():
            eps_p = unet(x, t, ctx)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: unet(x, t, ctx), runs=5)
        with ops.plain_reference():
            plain_ms = cuda_ms(lambda: unet(x, t, ctx), runs=5)
    assert counts == PER_UNET_EVAL, (counts, PER_UNET_EVAL)
    assert torch.isfinite(eps_k).all() and eps_k.shape == (b, h8, h8, 4)
    rel_l2 = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    log(f"[phase 11] unet sd1 B={b} 64x64 bf16 launches={counts} "
        f"rel_l2={rel_l2:.3e} eps_rms={eps_p.pow(2).mean().sqrt().item():.4f} "
        f"kernel_path_ms={ms:.3f} plain_path_ms={plain_ms:.3f}")
    assert rel_l2 <= REL_TOL, rel_l2
    del models, unet
    torch.cuda.empty_cache()


def phase12() -> dict:
    """Path A: Wukong txt2img 512^2, DPM-Solver++ 2M 15 steps, CFG 7.5,
    batch 4 (the JAX CLI's wukong defaults), and a rerun."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    path, batch, size = "wukong_txt2img_512_dpm15_b4", 4, 512
    models = wukong_models("wukong", torch.Generator(device="cuda").manual_seed(4))
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=size, width=size, num_steps=15, sampler="dpm", guidance_scale=7.5,
        batch_size=batch)
    tokens, uncond = zh_tokens(batch, 5), zh_tokens(batch, None)
    run = lambda: fn(models, tokens, uncond,  # noqa: E731
                     torch.Generator(device="cuda").manual_seed(11))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    img1, first_s = timed(run)
    counts = read_counts()
    img2, batch_s = timed(run)
    expected = expected_counts(path)
    assert counts == expected, (path, counts, expected)
    assert img1.shape == (batch, size, size, 3) and img1.dtype == torch.uint8
    assert torch.equal(img1, img2), "same generator seed gave different images"
    assert img1.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 12] {path} launches={counts} expected={expected} "
        f"first_run_s={first_s:.3f} s_per_batch={batch_s:.3f} "
        f"img_per_s={batch / batch_s:.4f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del models
    torch.cuda.empty_cache()
    return counts


def phase13() -> dict:
    """Path B: Wukong inpaint 512^2 (9-channel UNet), PLMS-50, CFG 7.5,
    batch 4, under MDT_WINO_TUNE=dma=0 so that its Winograd sites take K3."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

    path, batch, size = "wukong_inpaint_512_plms50_b4_dma0", 4, 512
    models = wukong_models("wukong-inpaint", torch.Generator(device="cuda").manual_seed(5))
    fn = StableDiffusionPipeline(models).build_inpaint(
        height=size, width=size, num_steps=50, sampler="plms", guidance_scale=7.5)
    ramp = torch.linspace(-1, 1, size, device="cuda")
    image = torch.stack([ramp[None, :].expand(size, size), ramp[:, None].expand(size, size),
                         torch.outer(ramp, ramp)], dim=-1)[None].repeat(batch, 1, 1, 1)
    mask = torch.zeros(batch, size, size, 1, device="cuda")
    mask[:, 128:384, 160:352] = 1.0               # repaint a central box
    tokens, uncond = zh_tokens(batch, 7), zh_tokens(batch, None)
    prev = os.environ.get("MDT_WINO_TUNE")
    os.environ["MDT_WINO_TUNE"] = "dma=0"
    try:
        reset_counts()
        img, batch_s = timed(lambda: fn(models, image, mask, tokens, uncond,
                                        torch.Generator(device="cuda").manual_seed(12)))
        counts = read_counts()
    finally:
        if prev is None:
            del os.environ["MDT_WINO_TUNE"]
        else:
            os.environ["MDT_WINO_TUNE"] = prev
    expected = expected_counts(path)
    assert counts == expected, (path, counts, expected)
    assert img.shape == (batch, size, size, 3) and img.dtype == torch.uint8
    assert img.float().std().item() > 1.0, "degenerate image"
    log(f"[phase 13] {path} launches={counts} expected={expected} "
        f"s_per_batch={batch_s:.3f}")
    del models
    torch.cuda.empty_cache()
    return counts


# Launches of the GLIDE cascade, counted by hand from GlideUNetConfig.base_64
# and upsample_256 (model_channels 192, head_ch 64), not from the port's
# gates. Attention: each site has Nk = Nq + 128 (the text tokens first). The
# base model attends at ds 2, 4, 8 and the middle; only ds2 (32^2: Nq 1024,
# Nk 1152, C 384) passes the 1024 / 512 token gates and, with block_q 1024,
# the footprint rule -> K1 at its 3 down and 4 up sites; ds4 (256 tokens),
# ds8 and the middle run einsum. The super-res model attends at ds 8, 16, 32
# and the middle: ds8 is its 32^2 level (Nq 1024, C 384) -> K1 at 2 down and
# 3 up sites. The xf's 128 tokens run einsum. Winograd (K2): stride-1 3x3
# convs with C_in >= 512 at 32^2 and 16^2. Base: at 16^2 the conv_out of
# down_2_0 and both convs of down_2_1, down_2_2 (5); both convs of the up
# resblock up_3_us (its conv_in runs after the 2x upsample, C_in 768) (2);
# both convs of up_2_0..3 (8); both of up_2_us, landing at 32^2 with C_in
# 576 (2); the conv_in of up_1_0..3 (C_in 960, 768, 768, 576; their conv_out
# has 384) (4): 21. Super-res: down_4_0's conv_out and both convs of down_4_1
# at 16^2 (3); both of up_5_us (2), of up_4_0..2 (6) and of up_4_us (2); the
# conv_in of up_3_0..2 at 32^2 (C_in 1152, 768, 768) (3): 16. The base runs
# 60 evals ("60" respacing), the super-res 27 ("fast27"); the SRGAN has no
# kernel site.
GLIDE_PER_EVAL = {"base": {"packed_attention": 7, "winograd": 21},
                  "super_res": {"packed_attention": 5, "winograd": 16}}
GLIDE_STEPS = {"base": 60, "super_res": 27}
GLIDE_BATCH, GLIDE_TEXT_LEN = 8, 12
TAIL_STEP = 13            # the super-res sampler step K9 is held at (of 27)


def glide_models():
    from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideModels

    return GlideModels.create(dtype=torch.bfloat16, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(6))


def glide_tokens(batch: int, ctx: int, vocab: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """A prompt of GLIDE_TEXT_LEN ids on every row, padded with the end
    token (vocab - 1), and its mask."""
    tokens = torch.full((batch, ctx), vocab - 1, dtype=torch.long, device="cuda")
    tokens[:, :GLIDE_TEXT_LEN] = torch.arange(101, 101 + GLIDE_TEXT_LEN, device="cuda")
    mask = torch.zeros_like(tokens)
    mask[:, :GLIDE_TEXT_LEN] = 1
    return tokens, mask


def phase14(models, gen: torch.Generator) -> None:
    """One full-width GLIDE base eval (CFG batch 16, 64x64) and one super-res
    eval (batch 8, 256x256, with a 64x64 low-res input), bf16, random weights
    with no zero-init, on the kernel path vs the plain path."""
    from minddiffusion_tpu_torch import ops

    xf = models.base.xf_config
    for stage, net, b, size in (("base", models.base, 2 * GLIDE_BATCH, 64),
                                ("super_res", models.super_res, GLIDE_BATCH, 256)):
        tokens, mask = glide_tokens(b, xf.text_ctx, xf.n_vocab)
        x = torch.randn(b, size, size, 3, generator=gen, device="cuda")
        t = torch.linspace(1, 999, b, device="cuda").round().long()
        low = (torch.rand(b, 64, 64, 3, generator=gen, device="cuda") * 2 - 1,) \
            if stage == "super_res" else ()
        with torch.inference_mode(), net.hoisted_winograd():
            xf_proj, xf_out = net.encode_text(tokens, mask)
            call = lambda: net.denoise(x, t, *low, xf_proj, xf_out)  # noqa: E731
            reset_counts()
            eps_k, v_k = call()
            counts = read_counts()
            with ops.plain_reference():
                eps_p, _ = call()
            torch.cuda.synchronize()
            ms = cuda_ms(call, runs=5)
            with ops.plain_reference():
                plain_ms = cuda_ms(call, runs=3)
        expected = {k: GLIDE_PER_EVAL[stage].get(k, 0) for k in KERNELS}
        assert counts == expected, (stage, counts, expected)
        assert eps_k.shape == v_k.shape == (b, size, size, 3)
        assert torch.isfinite(eps_k).all() and torch.isfinite(v_k).all(), stage
        rel_l2 = ((eps_k - eps_p).norm() / eps_p.norm()).item()
        log(f"[phase 14] unet glide {stage} B={b} {size}x{size} bf16 launches={counts} "
            f"rel_l2={rel_l2:.3e} eps_rms={eps_p.pow(2).mean().sqrt().item():.4f} "
            f"kernel_path_ms={ms:.3f} plain_path_ms={plain_ms:.3f}")
        assert rel_l2 <= REL_TOL, (stage, rel_l2)
    torch.cuda.empty_cache()


def phase15(models) -> "tuple[dict, torch.Tensor]":
    """The GLIDE cascade at the JAX package's defaults, batch 8, and a rerun
    with the same seed. Returns the launch counts and the base images."""
    from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideCascadePipeline

    b, xf = GLIDE_BATCH, models.base.xf_config
    assert (models.base_schedule.num_timesteps, models.sr_schedule.num_timesteps) == (
        GLIDE_STEPS["base"], GLIDE_STEPS["super_res"])
    fn = GlideCascadePipeline(models).build_generate(batch_size=b)
    tokens, mask = glide_tokens(b, xf.text_ctx, xf.n_vocab)
    run = lambda timings=None: fn(  # noqa: E731
        models, tokens, mask, torch.Generator(device="cuda").manual_seed(13), timings=timings)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out1, first_s = timed(run)
    counts = read_counts()
    stage_s: dict = {}
    out2, batch_s = timed(lambda: run(stage_s))
    expected = {k: sum(GLIDE_PER_EVAL[st].get(k, 0) * n for st, n in GLIDE_STEPS.items())
                for k in KERNELS}
    assert counts == expected, (counts, expected)
    for stage, side in (("base", 64), ("super_res", 256), ("srgan", 1024)):
        img = out1[stage]
        assert img.shape == (b, side, side, 3) and img.dtype == torch.uint8, (stage, img.shape)
        assert torch.equal(img, out2[stage]), f"{stage}: same seed gave different images"
        assert img.float().std().item() > 1.0, f"{stage}: degenerate image"
    log(f"[phase 15] glide_cascade_b{b} launches={counts} expected={expected} "
        f"first_run_s={first_s:.3f} s_per_batch={batch_s:.3f} img_per_s={b / batch_s:.4f} "
        + " ".join(f"{k}_s={v:.3f}" for k, v in stage_s.items())
        + f" peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return counts, out1["base"]


def tail_bound(bh: int, h: int, w: int, c: int, co: int, bx: int) -> "tuple[float, str]":
    """K9's bound: the bf16 products of the 3x3 conv to co channels (its
    inputs are bf16) against reading h, x, the affine, the weights and the
    step coefficients once and writing x_{t-1} once."""
    return bound(2.0 * 9 * c * co * bh * h * w,
                 2.0 * bh * h * w * c + 8.0 * bx * h * w * co + 8.0 * bh * c
                 + 4.0 * (9 * c * co + co + 4))


def phase16(models, img64_u8: torch.Tensor, gen: torch.Generator, table: dict) -> None:
    """K9 in "glide" mode on the out_norm input of the super-res UNet at
    sampler step TAIL_STEP of a full super-res run (batch 8, 256 px), with
    that step's DDIM coefficients, against its plain version and the port's
    own unfused step; in "sd" mode on seeded features at the SD2 main-path
    shape (CFG batch 16, 64x64, C 320 -> 4) with a DDIM-50 step's
    coefficients and guidance 9.0. Beside each: the unfused chain on the same
    inputs (the GN affine + SiLU from the same mult / add, cuDNN's conv to
    the eps channels, the sampler step from the same coefficients)."""
    from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule, make_ddim_timesteps
    from minddiffusion_tpu_torch.ops import glide_tail as gt
    from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideCascadePipeline

    b, xf = GLIDE_BATCH, models.base.xf_config
    tokens, mask = glide_tokens(b, xf.text_ctx, xf.n_vocab)
    fn = GlideCascadePipeline(models).build_generate(batch_size=b)
    with gt.sr_tail_probe(models.super_res.unet, models.sr_schedule, TAIL_STEP) as probe:
        fn.sr_stage(models, img64_u8.float() / 127.5 - 1.0, tokens, mask, gen, None)
    args = [probe[k] for k in ("h", "x", "mult", "add", "w_eps", "b_eps", "coefs")]
    w_g = args[4].permute(3, 2, 0, 1).to(torch.bfloat16)
    b_g = args[5].to(torch.bfloat16)
    sr, srm1, sap, s1map = (float(v) for v in args[6])

    def glide_unfused():
        hh, x, mult, add = args[:4]
        xn = F.silu(hh.float() * mult[:, None, None] + add[:, None, None]).to(torch.bfloat16)
        eps = F.conv2d(xn.permute(0, 3, 1, 2), w_g, b_g, padding=1).permute(0, 2, 3, 1)
        px0 = (sr * x - srm1 * eps.float()).clamp(-1.0, 1.0)
        return sap * px0 + s1map * ((sr * x - px0) / srm1)

    # "sd": CFG batch [uncond; cond] of the SD2 main path at a DDIM-50 step
    bh, hw, c, co = 16, 64, 320, 4
    sd = DiffusionSchedule.create()
    ts = make_ddim_timesteps(50, sd.num_timesteps)
    a_t, a_prev = (float(sd.alphas_cumprod[int(i)]) for i in (ts[25], ts[24]))
    c_x = (a_prev / a_t) ** 0.5
    c_eps = (1 - a_prev) ** 0.5 - (a_prev * (1 - a_t) / a_t) ** 0.5
    h = torch.randn(bh, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
    sd_args = [h, torch.randn(bh // 2, hw, hw, co, generator=gen, device="cuda"),
               1.0 + 0.1 * torch.randn(bh, c, generator=gen, device="cuda"),
               0.1 * torch.randn(bh, c, generator=gen, device="cuda"),
               torch.randn(3, 3, c, co, generator=gen, device="cuda") * (9 * c) ** -0.5,
               0.1 * torch.randn(co, generator=gen, device="cuda"),
               torch.tensor([9.0, c_x, c_eps, 0.0], device="cuda")]
    w_sd = sd_args[4].permute(3, 2, 0, 1).to(torch.bfloat16)
    b_sd = sd_args[5].to(torch.bfloat16)

    def sd_unfused():
        hh, x, mult, add = sd_args[:4]
        xn = F.silu(hh.float() * mult[:, None, None] + add[:, None, None]).to(torch.bfloat16)
        eps = F.conv2d(xn.permute(0, 3, 1, 2), w_sd, b_sd, padding=1).permute(0, 2, 3, 1)
        u, cond = eps.float().chunk(2)
        return c_x * x + c_eps * (u + 9.0 * (cond - u))

    rec = table["glide_tail"]
    with torch.inference_mode():
        for label, mode, a, unfused in (("glide_sr_256", "glide", args, glide_unfused),
                                        ("sd_cfg_64x64", "sd", sd_args, sd_unfused)):
            ref = gt.PLAIN[mode](*a)
            got = gt.tail_step(*a, mode=mode)
            chain = unfused()
            torch.cuda.synchronize()
            assert torch.isfinite(got).all() and got.shape == a[1].shape, label
            abs_err, err = errors(got, ref)
            _, err_chain = errors(got, chain)
            ms = cuda_ms(lambda: gt.tail_step(*a, mode=mode))
            plain_ms = cuda_ms(lambda: gt.PLAIN[mode](*a), runs=5)
            unfused_ms = cuda_ms(unfused, runs=5)
            nb, hh, ww, cc = a[0].shape
            bound_ms, bound_by = tail_bound(nb, hh, ww, cc, a[4].shape[-1], a[1].shape[0])
            extra = ""
            if mode == "glide":
                _, err_port = errors(got, probe["x_prev"])
                _, err_chain_port = errors(chain, probe["x_prev"])
                extra = (f" rel_err_vs_port_step={err_port:.3e}"
                         f" unfused_vs_port_step={err_chain_port:.3e}")
                assert err_port <= REL_TOL, (label, err_port)
            log(f"[phase 16] glide_tail {label} mode={mode} h={tuple(a[0].shape)} "
                f"co={a[4].shape[-1]} max_abs_err={abs_err:.3e} rel_err={err:.3e} "
                f"rel_err_vs_unfused={err_chain:.3e}{extra} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} unfused_chain_ms={unfused_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by})")
            assert err <= REL_TOL and err_chain <= REL_TOL, (label, err, err_chain)
            rec["cases"].append(dict(case=label, abs_err=abs_err, rel_err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=None,
                                     unfused_ms=unfused_ms, bound_ms=bound_ms,
                                     bound_by=bound_by))


GN_CASES = [(16, 64, 64, 320), (16, 32, 32, 640), (16, 16, 16, 1280), (3, 64, 64, 320)]


def stats_bound(b: int, h: int, w: int, c: int) -> "tuple[float, str]":
    """K6's bound: reading x once in bf16 and writing s1, s2 in fp32 (the 3
    flops an element are far below the ridge)."""
    return bound(3.0 * b * h * w * c, 2.0 * b * h * w * c + 8.0 * b * c)


def phase17(gen: torch.Generator, table: dict) -> None:
    """K6 (channel sums) against its plain version at the UNet's GroupNorm
    input shapes, in both memory orders, beside the two torch reductions;
    its VJP against autograd through the plain version. Its check on real
    ResBlock inputs runs inside phase 19 (`hold_k6_on_resblocks`)."""
    from minddiffusion_tpu_torch.ops import gn_stats

    for b, h, w, c in GN_CASES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
        xt = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
        ref = gn_stats.channel_sums_plain(x)
        for layout, xx in (("bhwc", x), ("hwbc", xt)):
            got = gn_stats.channel_sums(xx, layout == "hwbc")
            torch.cuda.synchronize()
            abs_err, err = max(errors(g, r) for g, r in zip(got, ref))
            assert all(torch.isfinite(g).all() for g in got), layout
            ms = cuda_ms(lambda: gn_stats.channel_sums(xx, layout == "hwbc"))
            plain_ms = cuda_ms(lambda: gn_stats.channel_sums_plain(xx), runs=5)
            # no single library call computes both sums: the yardstick is two
            reductions_ms = cuda_ms(lambda: (xx.float().sum((1, 2)),
                                             (xx.float() ** 2).sum((1, 2))))
            bound_ms, bound_by = stats_bound(b, h, w, c)
            label = f"{b}x{h}x{w}x{c}_{layout}"
            log(f"[phase 17] channel_sums {label} max_abs_err={abs_err:.3e} "
                f"rel_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"torch_reductions_ms={reductions_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
            assert err <= REL_TOL, (label, err)
            table["channel_sums"]["cases"].append(
                dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, unfused_ms=reductions_ms, bound_ms=bound_ms,
                     bound_by=bound_by))
    x = torch.randn(3, 32, 32, 640, generator=gen, device="cuda").to(torch.bfloat16)
    g1, g2 = (torch.randn(3, 640, generator=gen, device="cuda") for _ in range(2))
    grads = []
    for fn in (gn_stats.channel_sums, gn_stats.channel_sums_plain):
        leaf = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(leaf), (leaf,), (g1, g2))[0])
    _, err = errors(*grads)
    log(f"[phase 17] channel_sums vjp (3, 32, 32, 640) rel_err_vs_autograd_plain={err:.3e}")
    assert err <= REL_TOL, err


def hold_k6_on_resblocks(captured: dict) -> None:
    """K6 against GroupNorm32.stat_sums (the sums GroupNorm32.affine builds
    its fold from) on ResBlock inputs caught in a train step."""
    from minddiffusion_tpu_torch.ops import gn_stats

    for name, (norm, x) in captured.items():
        ref = norm.stat_sums(x)
        for transposed in (False, True):
            xx = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3) if transposed else x
            got = gn_stats.channel_sums(xx, transposed)
            abs_err, err = max(errors(g, r) for g, r in zip(got, ref))
            log(f"[phase 17] channel_sums on {name} input {tuple(x.shape)} "
                f"transposed={transposed} max_abs_err={abs_err:.3e} "
                f"rel_err_vs_groupnorm_sums={err:.3e}")
            assert err <= REL_TOL, (name, err)


FF_CASES = [("ds1_16x4096x320", 16, 4096, 320), ("ds2_16x1024x640", 16, 1024, 640),
            ("ds4_16x256x1280", 16, 256, 1280)]
FF_SITES = {"ds1": "input_blocks.1.1.transformer_blocks.0",
            "ds2": "input_blocks.4.1.transformer_blocks.0",
            "ds4": "input_blocks.7.1.transformer_blocks.0"}


def ff_bound(b: int, n: int, c: int, f: int) -> "tuple[float, str]":
    """K5's bound: the two products' 2*B*N*3*C*F bf16 flops against reading x,
    the weights and biases once and writing y."""
    return bound(2.0 * b * n * 3 * c * f,
                 2.0 * (2 * b * n * c + 3 * c * f + 2 * f + 3 * c))


def phase18(gen: torch.Generator, table: dict) -> None:
    """K5 (fused LN -> GEGLU -> FF -> residual) against its plain version at
    the SD2 transformer widths (CFG batch 16, 512^2: ds1 4096 tokens x 320,
    ds2 1024 x 640, ds4 256 x 1280; F = 4C), beside the unfused bf16 chain
    (no single library call computes it); then against the port's own
    `x + ff(norm3(x))` on the ds1, ds2 and ds4 inputs caught in one full-width
    SD2 UNet eval. No path launches K5 (the JAX package retired its hook)."""
    from minddiffusion_tpu_torch.ops import fused_ff

    rec = table["fused_ff"]
    with torch.inference_mode():
        for label, b, n, c in FF_CASES:
            f = 4 * c
            rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
            args = (rand(b, n, c).to(torch.bfloat16), 1.0 + 0.1 * rand(c), 0.1 * rand(c),
                    (rand(2 * f, c) * c ** -0.5).to(torch.bfloat16),
                    (0.1 * rand(2 * f)).to(torch.bfloat16),
                    (rand(c, f) * f ** -0.5).to(torch.bfloat16),
                    (0.1 * rand(c)).to(torch.bfloat16))
            x, ln_w, ln_b, w1, b1, w2, b2 = args
            ref = fused_ff.fused_ff_plain(*args)
            got = fused_ff.fused_ln_geglu_ff(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all() and got.shape == x.shape, label
            abs_err, err = errors(got, ref)
            ln_wb, ln_bb = ln_w.to(torch.bfloat16), ln_b.to(torch.bfloat16)

            def unfused():
                h = F.layer_norm(x, (c,), ln_wb, ln_bb, 1e-5)
                a, gate = F.linear(h, w1, b1).chunk(2, dim=-1)
                return x + F.linear(a * F.gelu(gate, approximate="tanh"), w2, b2)

            _, err_chain = errors(unfused(), ref)
            ms = cuda_ms(lambda: fused_ff.fused_ln_geglu_ff(*args))
            plain_ms = cuda_ms(lambda: fused_ff.fused_ff_plain(*args), runs=5)
            unfused_ms = cuda_ms(unfused)
            bound_ms, bound_by = ff_bound(b, n, c, f)
            log(f"[phase 18] fused_ff {label} F={f} max_abs_err={abs_err:.3e} "
                f"rel_err={err:.3e} unfused_vs_plain={err_chain:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} unfused_chain_ms={unfused_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by})")
            assert err <= REL_TOL, (label, err)
            rec["cases"].append(dict(case=label, abs_err=abs_err, rel_err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=None,
                                     unfused_ms=unfused_ms, bound_ms=bound_ms,
                                     bound_by=bound_by))
        del args, x, ref, got
        models = sd2_models(gen)
        unet = models.unet
        blocks = {site: unet.get_submodule(path) for site, path in FF_SITES.items()}
        caught = {}
        def catch(site):
            def hook(mod, inp):        # returns None: the input is left as it is
                caught.setdefault(site, inp[0].clone())
            return hook

        hooks = [blk.norm3.register_forward_pre_hook(catch(site))
                 for site, blk in blocks.items()]
        x8 = torch.randn(16, 64, 64, 4, generator=gen, device="cuda")
        t = torch.linspace(1, 981, 16, device="cuda").round().long()
        ctx = torch.randn(16, 77, 1024, generator=gen, device="cuda")
        with unet.hoisted_winograd():
            unet(x8, t, ctx)
        for h in hooks:
            h.remove()
        for site, blk in blocks.items():
            x = caught[site]
            ref = x + blk.ff(blk.norm3(x))
            got = fused_ff.fused_ln_geglu_ff(x, *fused_ff.block_args(blk))
            torch.cuda.synchronize()
            abs_err, err = errors(got, ref)
            log(f"[phase 18] fused_ff on the {site} block input {tuple(x.shape)} of an SD2 "
                f"UNet eval: max_abs_err={abs_err:.3e} rel_err_vs_port_block={err:.3e}")
            assert err <= REL_TOL, (site, err)
    del models, unet, blocks, caught
    torch.cuda.empty_cache()


TRAIN_BATCH, TRAIN_SIZE = 3, 512
RESBLOCK_SITES = ("input_blocks.1.0", "input_blocks.4.0", "input_blocks.7.0",
                  "middle_block.0", "output_blocks.3.0")


def train_batch(gen: torch.Generator, vocab: int, reg: bool = False) -> dict:
    def one():
        return (torch.rand(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3, generator=gen,
                           device="cuda") * 2 - 1,
                torch.randint(0, vocab, (TRAIN_BATCH, 77), generator=gen, device="cuda"))
    image, tokens = one()
    out = {"image": image, "tokens": tokens}
    if reg:
        out["reg_image"], out["reg_tokens"] = one()
    return out


def phase19(gen: torch.Generator) -> dict:
    """SD2 finetune at 512^2, batch 3, fp32 master weights, bf16 compute,
    warmup 0: one warm step, 3 timed steps with launch counts, the finite
    flag and moved params; the P5 check (the UNet gradient of the kernel
    path against the plain path's on one batch with fixed draws), passing,
    and failing without the gradient bridges; and K6 on ResBlock inputs
    caught in a step."""
    from minddiffusion_tpu_torch import ops
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels
    from minddiffusion_tpu_torch.train import trainer

    torch.cuda.reset_peak_memory_stats()
    models = SDModels.create(family="sd2", dtype=torch.bfloat16, param_dtype=torch.float32,
                             attn_impl=None, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(11))
    config = trainer.TrainConfig(warmup_steps=0)
    state = trainer.create_train_state(models, config)
    step = trainer.make_train_step(config)
    batch = train_batch(gen, 49408)
    unet_before = {n: p.detach().clone() for n, p in models.unet.named_parameters()}
    expected = expected_counts("sd2_finetune_512_b3")
    captured = {}

    def catch(site):
        def hook(mod, inp):            # returns None: the input is left as it is
            captured.setdefault(site, (mod.in_layers[0], inp[0].detach().clone()))
        return hook

    hooks = [models.unet.get_submodule(s).register_forward_pre_hook(catch(s))
             for s in RESBLOCK_SITES]
    metrics = step(state, batch, 0)                       # warm step
    for h in hooks:
        h.remove()
    times, counts = [], None
    for i in range(3):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        counts = read_counts()
        assert counts == expected, (counts, expected)
    host = {k: v.item() for k, v in metrics.items()}
    moved = sum(not torch.equal(p, unet_before[n]) for n, p in models.unet.named_parameters())
    n_params = len(unet_before)
    s_step = statistics.median(times)
    log(f"[phase 19] sd2 finetune 512x512 B={TRAIN_BATCH} fp32 master / bf16 compute "
        f"launches_per_step={counts} expected={expected} s_per_step={times} "
        f"median_s={s_step:.4f} img_per_s={TRAIN_BATCH / s_step:.4f} metrics={host} "
        f"unet_tensors_moved={moved}/{n_params} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    assert host["grads_finite"] == 1.0 and all(map(lambda v: v == v, host.values()))
    assert moved == n_params, (moved, n_params)
    del unet_before
    hold_k6_on_resblocks(captured)
    del captured

    # P5: the kernel path's UNet gradient against the plain path's
    g = torch.Generator(device="cuda").manual_seed(12)
    draws = {"t": torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda"),
             "noise": torch.randn(TRAIN_BATCH, 64, 64, 4, generator=g, device="cuda"),
             "enc_noise": torch.randn(TRAIN_BATCH, 64, 64, 4, generator=g, device="cuda")}
    loss_and_grads = trainer.make_loss_and_grads(config)
    names = [n for n in state.grad_params if n.startswith("model.diffusion_model.")]
    reset_counts()
    m_k, grads_k = loss_and_grads(state, batch, None, draws)
    grads_k = {n: grads_k[n] for n in names}
    counts_k = read_counts()
    with ops.plain_reference():
        m_p, grads_p = loss_and_grads(state, batch, None, draws)
    grads_p = {n: grads_p[n] for n in names}
    num = sum((grads_k[n].float() - grads_p[n].float()).pow(2).sum() for n in names)
    den = sum(grads_p[n].float().pow(2).sum() for n in names)
    rel_l2 = (num / den).sqrt().item()
    zero_k = sum(int(grads_k[n].abs().sum().item() == 0) for n in names)
    log(f"[phase 19] P5 check: unet grad rel_l2 kernel vs plain path = {rel_l2:.3e} "
        f"(loss {m_k['loss'].item():.6f} vs {m_p['loss'].item():.6f}; "
        f"kernel-path launches {counts_k}; all-zero unet grads on the kernel path "
        f"{zero_k}/{len(names)})")
    assert rel_l2 <= 5e-2, rel_l2
    del grads_k
    # the same check with the bridges taken out: it must fail
    with without_gradient_bridges():
        _, grads_b = loss_and_grads(state, batch, None, draws)
    num = sum((grads_b[n].float() - grads_p[n].float()).pow(2).sum() for n in names)
    rel_l2_b = (num / den).sqrt().item()
    zero_b = sum(int(grads_b[n].abs().sum().item() == 0) for n in names)
    log(f"[phase 19] P5 check without the gradient bridges (the wrappers before the "
        f"repair): rel_l2={rel_l2_b:.3e}, all-zero unet grads {zero_b}/{len(names)}")
    assert rel_l2_b > 5e-2, rel_l2_b
    del state, models, grads_b, grads_p, step, loss_and_grads
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def without_gradient_bridges():
    """The kernel wrappers as they were before the gradient bridges: the
    kernel's output carries no grad_fn, so autograd drops its branch."""
    from minddiffusion_tpu_torch.ops import flash_attention as fa, winograd as wg

    def wino(x, w, b, gathered):
        u = wg.transform_weights(w.detach().to(x.dtype).permute(2, 3, 1, 0))
        conv = wg.conv3x3_winograd_gathered if gathered else wg.conv3x3_winograd
        return conv(x, u.to(x.dtype).contiguous(), b.detach().float().contiguous())

    patches = {fa._PackedAttentionFn: fa._packed_launch,
               fa._FlashAttentionFn: fa._flash_launch, wg._WinogradConvFn: wino}
    for fn, launch in patches.items():
        fn.apply = launch          # shadows torch.autograd.Function.apply
    try:
        yield
    finally:
        for fn in patches:
            del fn.apply


ZH_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "一", "只", "猫", "狗", "照", "片", "sks"]


def phase20(tmp: str) -> "tuple[dict, dict]":
    """Wukong LoRA at full width through the train CLI (--family wukong
    --train_mode lora, 512^2, batch 3, 3 steps) on 6 seeded PNGs with a
    CSV and a synthetic vocab_zh.txt: only lora_a / lora_b move, every base
    tensor stays bytewise; the adapter checkpoint holds only LoRA entries and
    reloads; the merged model's eps is within 2e-2 relative L2 of the LoRA
    model's. Then one DreamBooth step through the same CLI."""
    import numpy as np
    from PIL import Image

    from minddiffusion_tpu_torch.cli import common, train as train_cli
    from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
    from minddiffusion_tpu_torch.models import lora
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    rng = np.random.default_rng(20)
    data, cls, assets = (os.path.join(tmp, d) for d in ("data", "cls", "assets"))
    for d in (data, cls, assets):
        os.makedirs(d)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (560, 600, 3), dtype=np.uint8)).save(
            os.path.join(data, f"im_{i}.png"))
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)).save(
            os.path.join(cls, f"c_{i}.png"))
    with open(os.path.join(data, "train.csv"), "w", encoding="utf-8") as f:
        f.write("dir,text\n" + "".join(f"im_{i}.png,一只猫的照片\n" for i in range(6)))
    with open(os.path.join(assets, "vocab_zh.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(ZH_VOCAB) + "\n")
    os.environ["MINDDIFFUSION_TPU_ASSETS"] = assets
    common_args = ["--family", "wukong", "--image_size", "512", "--train_batch_size", "3",
                   "--warmup_steps", "0", "--start_learning_rate", "1e-4", "--seed", "5",
                   "--save_checkpoint_steps", "3"]
    base = common.build_sd("wukong", "bf16", torch.device("cuda"), seed=5,
                           param_dtype=torch.float32, enable_lora=True, exact_attention=True)
    before = {k: v.detach().cpu().clone() for kind, m in base.modules().items()
              for k, v in [(f"{kind}.{n}", p) for n, p in m.state_dict().items()]}
    del base
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "lora_out")
    reset_counts()
    t0 = time.time()
    state = train_cli.main(common_args + ["--train_mode", "lora", "--max_steps", "3",
                                          "--data_path", data, "--output_path", out])
    torch.cuda.synchronize()
    lora_s = time.time() - t0
    counts = read_counts()
    expected = expected_counts("wukong_lora_512_b3_3steps")
    assert counts == expected, (counts, expected)
    after = {f"{kind}.{n}": v for kind, m in state.models.modules().items()
             for n, v in m.state_dict().items()}
    changed = {k for k in after if not torch.equal(after[k].cpu(), before[k])}
    lora_keys = {k for k in after if lora.is_lora_name(k)}
    assert changed and changed <= lora_keys, sorted(changed - lora_keys)[:5]
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    adapters = mgr.restore_latest()
    full = state.models.state_dict()
    assert mgr.latest_step() == 3 and set(adapters) == {k for k in full if lora.is_lora_name(k)}
    assert all(torch.equal(v, full[k].cpu()) for k, v in adapters.items())
    # reload: the adapters over a fresh LoRA model's state dict
    fresh = common.build_sd("wukong", "bf16", torch.device("cuda"), seed=5,
                            param_dtype=torch.float32, enable_lora=True, exact_attention=True)
    sd = lora.apply_lora_state_dict(fresh.state_dict(), adapters)
    fresh.load_state_dict({k: v.float().cpu().numpy() for k, v in sd.items()})
    # the merged weights in the model without LoRA
    merged = SDModels.create(family="wukong", dtype=torch.bfloat16, param_dtype=torch.float32,
                             attn_impl=None, device="cuda")
    merged.load_state_dict({k: v.float().cpu().numpy()
                            for k, v in lora.merge_lora_state_dict(full).items()})
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(4, 64, 64, 4, generator=g, device="cuda")
    t = torch.tensor([10, 300, 600, 900], device="cuda")
    ctx = torch.randn(4, 77, 768, generator=g, device="cuda")
    with torch.inference_mode():
        eps_lora = state.models.unet(x, t, ctx)
        eps_reload = fresh.unet(x, t, ctx)
        eps_merged = merged.unet(x, t, ctx)
    rel_merged = ((eps_merged - eps_lora).norm() / eps_lora.norm()).item()
    rel_reload = ((eps_reload - eps_lora).norm() / eps_lora.norm()).item()
    assert rel_reload <= 1e-3, rel_reload
    b_norm = max(v.abs().max().item() for k, v in adapters.items() if k.endswith(".lora_b"))
    log(f"[phase 20] wukong lora 512x512 B=3 3 steps through cli/train.py: "
        f"launches={counts} expected={expected} wall_s={lora_s:.2f} "
        f"changed={len(changed)} lora_tensors={len(lora_keys)} adapters_saved={len(adapters)} "
        f"max|lora_b|={b_norm:.3e} merged_eps_rel_l2={rel_merged:.3e} "
        f"reloaded_eps_rel_l2={rel_reload:.3e}")
    assert rel_merged <= REL_TOL, rel_merged
    del state, fresh, merged, full, after, before, adapters, sd
    torch.cuda.empty_cache()

    reset_counts()
    db = train_cli.main(common_args + ["--train_mode", "dreambooth", "--max_steps", "1",
                                       "--instance_data_dir", data, "--class_data_dir", cls,
                                       "--token", "sks", "--class_word", "猫",
                                       "--train_data_repeats", "1",
                                       "--output_path", os.path.join(tmp, "db_out")])
    torch.cuda.synchronize()
    db_counts = read_counts()
    expected_db = expected_counts("wukong_dreambooth_512_b3_1step")
    log(f"[phase 20] wukong dreambooth 512x512 B=3 1 step through cli/train.py: "
        f"launches={db_counts} expected={expected_db} step={db.step} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    assert db_counts == expected_db, (db_counts, expected_db)
    del db
    torch.cuda.empty_cache()
    return counts, db_counts



CONV_CASES = [  # (label, B, H, W, C): benchmarks/research/bench_conv.py's shapes, C -> C
    ("unet_64x64_320", 16, 64, 64, 320), ("unet_32x32_640", 16, 32, 32, 640),
    ("unet_16x16_1280", 16, 16, 16, 1280), ("unet_8x8_1280", 16, 8, 8, 1280),
    ("vae_64x64_512", 8, 64, 64, 512), ("vae_128x128_512", 8, 128, 128, 512),
    ("vae_256x256_256", 8, 256, 256, 256), ("vae_512x512_128", 8, 512, 512, 128),
]
# v2 with its fused GN-affine + SiLU prologue and residual epilogue
FUSED_CONV_CASES = [("fused_64x64_320", 16, 64, 64, 320), ("fused_32x32_640", 16, 32, 32, 640)]


def conv_bound(b: int, h: int, w: int, ci: int, co: int, flops: float,
               extra_bytes: float = 0.0) -> "tuple[float, str]":
    """`flops` against reading x (bf16), the bf16 weights and the fp32 bias
    once and writing y (bf16), plus `extra_bytes`."""
    return bound(flops, 2.0 * b * h * w * (ci + co) + 2.0 * 9 * ci * co + 4.0 * co
                 + extra_bytes)


def cudnn_operands(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor):
    """The NCHW view of NHWC x and the OIHW weight in channels-last memory,
    both bf16, and the bf16 bias: cuDNN's conv on the kernels' inputs."""
    w = kern.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return x.permute(0, 3, 1, 2), w, bias.to(torch.bfloat16)


def phase21(gen: torch.Generator, table: dict) -> None:
    """K7 v1 and v2 against their plain versions at bench_conv.py's eight
    shapes (C -> C), beside cuDNN's bf16 channels-last conv; v2 with the
    fused GN affine + SiLU prologue and the residual at the UNet's 64^2 and
    32^2 widths, beside the unfused chain (affine + SiLU, cuDNN's conv, bias
    + residual). No path launches K7 (the JAX package has none)."""
    from minddiffusion_tpu_torch.ops import conv3x3 as cv

    for label, b, h, w, c in CONV_CASES + FUSED_CONV_CASES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
        kern = (torch.randn(3, 3, c, c, generator=gen, device="cuda")
                * (9 * c) ** -0.5).to(torch.bfloat16)
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        x_cl, w_cl, bias16 = cudnn_operands(x, kern, bias)
        flops = 2.0 * b * h * w * 9 * c * c
        if label.startswith("fused"):
            gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
            scale, shift = cv.groupnorm_affine_fold(x, gamma, beta)
            res = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
            kw = dict(prologue_scale=scale, prologue_shift=shift, silu_prologue=True,
                      residual=res)

            def chain():
                xa = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
                y = F.conv2d(xa.to(torch.bfloat16).permute(0, 3, 1, 2), w_cl, padding=1)
                return (y.permute(0, 2, 3, 1).float() + bias + res.float()).to(torch.bfloat16)

            runs = [("conv3x3_gemm", lambda: cv.conv3x3_gemm(x, kern, bias, **kw),
                     lambda: cv.conv3x3_gemm_plain(x, kern, bias, **kw), chain,
                     2.0 * b * h * w * c + 8.0 * b * c)]
        else:
            def cudnn():
                return F.conv2d(x_cl, w_cl, bias16, padding=1)

            runs = [("conv3x3_v1", lambda: cv.conv3x3_pallas(x, kern, bias),
                     lambda: cv.conv3x3_pallas_plain(x, kern, bias), cudnn, 0.0),
                    ("conv3x3_gemm", lambda: cv.conv3x3_gemm(x, kern, bias),
                     lambda: cv.conv3x3_gemm_plain(x, kern, bias), cudnn, 0.0)]
        timed = {}
        for name, kernel_fn, plain_fn, library_fn, extra in runs:
            ref = plain_fn()
            got = kernel_fn()
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), (name, label)
            abs_err, err = errors(got, ref)
            del ref
            # v1 and v2 with no prologue are one launch of one kernel: timed once
            if not timed:
                timed = dict(ms=cuda_ms(kernel_fn), library_ms=cuda_ms(library_fn))
            ms, library_ms = timed["ms"], timed["library_ms"]
            plain_ms = cuda_ms(plain_fn, runs=3)
            bound_ms, bound_by = conv_bound(b, h, w, c, c, flops, extra)
            log(f"[phase 21] {name} {label} B={b} {h}x{w} {c}->{c} max_abs_err={abs_err:.3e} "
                f"rel_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"{'unfused_chain' if extra else 'cudnn_conv'}_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={flops / ms / 1e9:.1f}")
            assert err <= REL_TOL, (name, label, err)
            table[name]["cases"].append(
                dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        del x, kern, x_cl, w_cl
        torch.cuda.empty_cache()


WINO43_CASES = [  # (label, B, H, W, C_in, C_out)
    ("unet_32x32_640", 16, 32, 32, 640, 640),     # bench_wino43_unet.py
    ("vae_128x128_512", 8, 128, 128, 512, 512),   # the module header's VAE shapes
    ("vae_256x256_256", 8, 256, 256, 256, 256),
    ("vae_512x512_128", 8, 512, 512, 128, 128),
    ("vae_256x256_512_256", 8, 256, 256, 512, 256),
]
WINO43_GRAD_CASE = (4, 128, 128, 256, 256)


def phase22(gen: torch.Generator, table: dict) -> None:
    """K8 (Winograd F(4x4, 3x3), U hoisted) against its plain F(4,3) at the
    UNet's 32^2 x 640 site and the VAE decoder's shapes, beside cuDNN's
    bf16 conv, with its error against the fp32 direct conv of the same bf16
    operands reported apart; then the gradient of conv3x3_winograd43_ad
    (direct-conv backward) against autograd through the plain F(4,3) at a
    VAE shape. No path launches K8 (the JAX package has none)."""
    from minddiffusion_tpu_torch.ops import winograd43 as w43

    for label, b, h, w, ci, co in WINO43_CASES:
        x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
        kern = torch.randn(3, 3, ci, co, generator=gen, device="cuda") * (9 * ci) ** -0.5
        bias = torch.randn(co, generator=gen, device="cuda") * 0.1
        u = w43.transform_weights43(kern).to(torch.bfloat16).contiguous()
        ref = w43.conv3x3_winograd43_plain(x, kern, bias, u)
        got = w43.conv3x3_winograd43(x, kern, bias, u)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), label
        abs_err, err = errors(got, ref)
        del ref
        x_cl, w_cl, bias16 = cudnn_operands(x, kern, bias)
        direct = F.conv2d(x_cl.float(), w_cl.float(), bias, padding=1).permute(0, 2, 3, 1)
        _, direct_err = errors(got, direct)
        direct_l2 = ((got.float() - direct).norm() / direct.norm()).item()
        del direct
        ms = cuda_ms(lambda: w43.conv3x3_winograd43(x, kern, bias, u))
        plain_ms = cuda_ms(lambda: w43.conv3x3_winograd43_plain(x, kern, bias, u), runs=3)
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, bias16, padding=1))
        p = b * (h // 4) * (w // 4)
        bound_ms, bound_by = bound(2.0 * 36 * p * ci * co,
                                   2.0 * b * h * w * (ci + co) + 2.0 * 36 * ci * co + 4.0 * co)
        log(f"[phase 22] winograd43 {label} B={b} {h}x{w} {ci}->{co} max_abs_err={abs_err:.3e} "
            f"rel_err={err:.3e} vs_direct_fp32: max_rel={direct_err:.3e} rel_l2={direct_l2:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} cudnn_conv_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
        assert err <= REL_TOL, (label, err)
        table["winograd43"]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                 direct_conv_rel_l2=direct_l2))
        del x, x_cl, w_cl, u
        torch.cuda.empty_cache()
    b, h, w, ci, co = WINO43_GRAD_CASE
    x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
    kern = torch.randn(3, 3, ci, co, generator=gen, device="cuda") * (9 * ci) ** -0.5
    bias = torch.randn(co, generator=gen, device="cuda") * 0.1
    g = torch.randn(b, h, w, co, generator=gen, device="cuda")
    grads = []
    for fn in (w43.conv3x3_winograd43_ad, w43.conv3x3_winograd43_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, kern, bias)]
        y = fn(*leaves)
        grads.append(torch.autograd.grad((y.float() * g).sum(), leaves))
    rels = [((a.float() - r.float()).norm() / r.float().norm()).item()
            for a, r in zip(*grads)]
    log(f"[phase 22] winograd43 gradient {WINO43_GRAD_CASE}: rel_l2 of (x, kernel, bias) "
        f"grads, direct-conv backward vs autograd through the plain F(4,3) = "
        + ", ".join(f"{r:.3e}" for r in rels))
    assert max(rels) <= 5e-2, rels
    del x, kern, grads
    torch.cuda.empty_cache()


# GLIDE training (phases 23, 24), launches per step counted from the same
# configs as GLIDE_PER_EVAL: a step runs one UNet forward (its K1 and K2
# sites, whatever the batch: the route reads only Nq, Nk and C) and the xf
# (128 tokens: einsum); the backward recomputes einsum attention and the
# direct conv, so it launches no kernel. Base: K1 7, K2 21; super-res: K1 5,
# K2 16.
GLIDE_TRAIN = {"base": (8, 64), "super_res": (2, 256)}   # TG1, TG2: (batch, px)
GLIDE_TRAIN_EMA = 0.9       # phase 23: one step moves the EMA far above its fp32 rounding
GRAD_REL_L2 = 5e-2          # TG1: each part's and each tensor's gradient vs the plain path
PATHS.update({
    "glide_base_train_64_b8": (GLIDE_PER_EVAL["base"], {}, 1),
    "glide_sr_train_256_b2": (GLIDE_PER_EVAL["super_res"], {}, 1),
    "glide_train_cli_base_3steps": (GLIDE_PER_EVAL["base"], {}, 3),
    "glide_train_cli_sr_2steps": (GLIDE_PER_EVAL["super_res"], {}, 2),
})


def glide_train_batch(gen: torch.Generator, b: int, size: int, super_res: bool) -> dict:
    image = torch.randint(0, 256, (b, size, size, 3), generator=gen, device="cuda")
    tokens, mask = glide_tokens(b, 128, 50001)
    out = {"image": image.float() / 127.5 - 1.0, "tokens": tokens, "mask": mask,
           "t": torch.randint(0, 1000, (b,), generator=gen, device="cuda"),
           "weights": torch.ones(b, device="cuda")}
    if super_res:
        out["low_res"] = out["image"].reshape(b, 64, size // 64, 64, size // 64, 3).mean((2, 4))
    return out


def rel_l2(got: dict, ref: dict, names) -> float:
    num = sum((got[n].float() - ref[n].float()).pow(2).sum() for n in names)
    den = sum(ref[n].float().pow(2).sum() for n in names)
    return (num / den).sqrt().item()


def per_tensor_rel_l2(got: dict, ref: dict, names) -> dict:
    """{name: ||got - ref|| / ||ref||}, one host sync for all of them (nan
    where ref is all zero)."""
    num = [(got[n].float() - ref[n].float()).norm() for n in names]
    den = [ref[n].float().norm() for n in names]
    return dict(zip(names, (torch.stack(num) / torch.stack(den)).tolist()))


def phase23(gen: torch.Generator) -> dict:
    """GLIDE training at full width, fp32 master weights under bf16 compute,
    seeded random weights: TG1 the base at 64 px, batch 8; TG2 the
    super-res at 256 px, batch 2. Each: a warm step, 3 timed steps (s/step,
    img/s, peak memory, launches per step), the loss finite, every tensor
    moved, the last step's EMA move against (1 - decay)(p - ema). On TG1
    the gradient of every UNet and xf param on the kernel path against the
    plain path's, pooled per part and tensor by tensor, passing, and failing
    without the gradient bridges."""
    from minddiffusion_tpu_torch import ops
    from minddiffusion_tpu_torch.cli import glide_train as gt

    counts_by_path = {}
    for stage, path in (("base", "glide_base_train_64_b8"),
                        ("super_res", "glide_sr_train_256_b2")):
        sr = stage == "super_res"
        b, size = GLIDE_TRAIN[stage]
        torch.cuda.reset_peak_memory_stats()
        ucfg, xcfg = gt.model_configs(sr, tiny=False)
        model = gt.build_model(sr, ucfg, xcfg, "cuda", torch.bfloat16, seed=23)
        state = gt.create_train_state(model, 1e-4, 0, 100_000)
        schedule = gt.glide_schedule(sr)
        step = gt.build_step(schedule, sr, GLIDE_TRAIN_EMA)
        batch = glide_train_batch(gen, b, size, sr)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        step(state, batch, 0)                                  # warm step
        expected = expected_counts(path)
        times, counts = [], None
        for i in range(3):
            if i == 2:
                ema_before = {n: e.clone() for n, e in state.ema.items()}
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            metrics = step(state, batch, 0)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            counts = read_counts()
            assert counts == expected, (stage, counts, expected)
        host = {k: v.item() for k, v in metrics.items()}
        assert all(map(math.isfinite, host.values())), host
        params = state.params
        moved = sum(not torch.equal(p, before[n]) for n, p in params.items())
        del before
        want = {n: torch.lerp(ema_before[n].double(), params[n].detach().double(),
                              1.0 - GLIDE_TRAIN_EMA) - ema_before[n].double()
                for n in params}
        got = {n: state.ema[n].double() - ema_before[n].double() for n in params}
        ema_err = rel_l2(got, want, list(params))
        ema_moved = sum(not torch.equal(state.ema[n], ema_before[n]) for n in params)
        del want, got, ema_before
        s_step = statistics.median(times)
        log(f"[phase 23] glide {stage} train {size}x{size} B={b} fp32 master / bf16 compute "
            f"launches_per_step={counts} expected={expected} s_per_step={times} "
            f"median_s={s_step:.4f} img_per_s={b / s_step:.4f} metrics={host} "
            f"tensors_moved={moved}/{len(params)} ema_moved={ema_moved}/{len(params)} "
            f"ema_step_rel_l2_vs_(1-decay)(p-ema)={ema_err:.3e} "
            f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        assert moved == ema_moved == len(params), (moved, ema_moved, len(params))
        assert ema_err <= 1e-3, ema_err
        counts_by_path[path] = counts
        if not sr:
            hold_glide_gradients(state, schedule, batch, gt, ops)
        del state, model, step, batch, params
        torch.cuda.empty_cache()
    return counts_by_path


def hold_glide_gradients(state, schedule, batch: dict, gt, ops) -> None:
    """TG1's gradient check (phase 19's P5 check on GLIDE, where K1's keys
    and values carry the 128 xf tokens first)."""
    g = torch.Generator(device="cuda").manual_seed(24)
    noise = torch.randn(batch["image"].shape, generator=g, device="cuda")
    reset_counts()
    m_k, grads_k = gt.loss_and_grads(state, schedule, False, batch, noise)
    counts_k = read_counts()
    with ops.plain_reference():
        m_p, grads_p = gt.loss_and_grads(state, schedule, False, batch, noise)
    parts = {"unet": [n for n in grads_p if n.startswith("unet.")],
                "xf": [n for n in grads_p if n.startswith("xf.")], "all": list(grads_p)}

    def held(grads: dict) -> tuple:
        """The pooled rel_l2 of each part; the count of tensors whose own
        rel_l2 is above the limit (or undefined); the three worst tensors."""
        each = per_tensor_rel_l2(grads, grads_p, parts["all"])
        over = sum(not r <= GRAD_REL_L2 for r in each.values())
        worst = sorted(each.items(), reverse=True,
                       key=lambda kv: kv[1] if kv[1] == kv[1] else math.inf)
        return ({k: rel_l2(grads, grads_p, names) for k, names in parts.items()}, over,
                [(n, f"{r:.3e}") for n, r in worst[:3]])

    rels, over, worst = held(grads_k)
    zero_k = sum(int(not grads_k[n].any()) for n in grads_k)
    log(f"[phase 23] TG1 gradient check: rel_l2 kernel vs plain path = "
        + " ".join(f"{k}={v:.3e}" for k, v in rels.items())
        + f"; per tensor: {over}/{len(grads_p)} above {GRAD_REL_L2}, worst {worst}"
        + f" (loss {m_k['loss'].item():.6f} vs {m_p['loss'].item():.6f}; kernel-path "
        f"launches {counts_k}; all-zero grads on the kernel path {zero_k}/{len(grads_k)})")
    assert max(rels.values()) <= GRAD_REL_L2 and over == 0 and zero_k == 0, (
        rels, over, worst, zero_k)
    del grads_k
    with without_gradient_bridges():
        _, grads_b = gt.loss_and_grads(state, schedule, False, batch, noise)
    rels_b, over_b, worst_b = held(grads_b)
    zero_b = sum(int(not grads_b[n].any()) for n in grads_b)
    log(f"[phase 23] TG1 gradient check without the gradient bridges: rel_l2 "
        + " ".join(f"{k}={v:.3e}" for k, v in rels_b.items())
        + f"; per tensor: {over_b}/{len(grads_p)} above {GRAD_REL_L2}, worst {worst_b}"
        + f", all-zero grads {zero_b}/{len(grads_b)}")
    assert rels_b["all"] > GRAD_REL_L2 and over_b > 0, (rels_b, over_b)


def phase24(tmp: str) -> dict:
    """`python -m minddiffusion_tpu_torch.cli.glide_train`'s main at its
    defaults (batch 2, full-width models, CRC-32 fallback tokens): the base
    for 3 steps and --super_res for 2, on 6 seeded PNGs under a TSV manifest.
    Each checkpoint holds {"params", "ema"}, each loads strictly into a
    fresh model; the base's EMA loads into the cascade; the fallback tokens
    are the same in two processes with different PYTHONHASHSEED."""
    import numpy as np
    from PIL import Image

    from minddiffusion_tpu_torch.cli import glide_train as gt
    from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
    from minddiffusion_tpu_torch.io.glide_weights import stage_state_dict
    from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideModels

    rng = np.random.default_rng(24)
    data = os.path.join(tmp, "glide_data")
    os.makedirs(os.path.join(data, "imgs"))
    rows = []
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)).save(
            os.path.join(data, "imgs", f"g{i}.png"))
        rows.append(f"imgs/g{i}.png\t一只猫 a cat number {i}")
    with open(os.path.join(data, "m.tsv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    manifests = os.path.join(data, "manifests.txt")
    with open(manifests, "w") as f:
        f.write(os.path.join(data, "m.tsv") + "\n")
    counts_by_path = {}
    for stage, path, steps, extra in (
            ("base", "glide_train_cli_base_3steps", 3, []),
            ("super_res", "glide_train_cli_sr_2steps", 2, ["--super_res"])):
        out = os.path.join(tmp, f"glide_{stage}")
        reset_counts()
        t0 = time.time()
        state = gt.main(["--image_caption_path_file", manifests, "--output_path", out,
                         "--max_steps", str(steps), "--save_checkpoint_steps", str(steps),
                         "--warmup_steps", "0", "--lr", "1e-4"] + extra)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        expected = expected_counts(path)
        assert state.step == steps and counts == expected, (stage, state.step, counts, expected)
        mgr = CheckpointManager(os.path.join(out, "ckpt"))
        saved = mgr.restore_latest()
        assert mgr.steps() == [1, steps] and set(saved) == {"params", "ema"}, mgr.steps()
        assert all(torch.equal(saved["params"][n], p.detach().cpu())
                   for n, p in state.params.items())
        assert all(torch.equal(saved["ema"][n], e.cpu()) for n, e in state.ema.items())
        del state
        torch.cuda.empty_cache()
        ucfg, xcfg = gt.model_configs(stage == "super_res", tiny=False)
        fresh = gt.build_model(stage == "super_res", ucfg, xcfg, "cuda", torch.bfloat16, 0)
        for tree in ("params", "ema"):
            fresh.load_state_dict(saved[tree], strict=True)
        del fresh
        if stage == "base":
            cascade = GlideModels.create(device="cuda", with_srgan=False)
            cascade.load_state_dict({**cascade.state_dict(),
                                    **stage_state_dict(saved["ema"], "base")})
            w = cascade.base.unet.out_conv.weight
            assert torch.equal(w.cpu(), saved["ema"]["unet.out_conv.weight"].to(w.dtype))
            del cascade
        log(f"[phase 24] glide_train {stage} {steps} steps batch 2 through the CLI: "
            f"launches={counts} expected={expected} wall_s={wall:.2f} "
            f"checkpoints={mgr.steps()} trees={sorted(saved)} tensors={len(saved['params'])} "
            f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        counts_by_path[path] = counts
        del saved
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    code = ("from minddiffusion_tpu_torch.cli.glide_train import fallback_tokens;"
            "print(fallback_tokens('一只猫 a cat number 1', 128)[0][:8].tolist())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(gt.__file__)))
    outs = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           check=True, cwd=os.path.dirname(root),
                           env=dict(os.environ, PYTHONHASHSEED=s)).stdout.strip()
            for s in ("1", "2")]
    log(f"[phase 24] fallback tokens under PYTHONHASHSEED 1 and 2: {outs[0]} / {outs[1]}")
    assert outs[0] == outs[1], outs
    return counts_by_path


# ---- serving (phases 25, 26) ---------------------------------------------

SERVE_BATCH = 8
SERVE_PROMPT = "a photograph of an astronaut riding a horse"


def toy_tokenize(prompt: str):
    """The stated stand-in for the CLIP BPE (its vocab file is not in the
    repository): SOT, each character hashed into [1, 49405), EOT, zeros to
    77. Different prompts get different ids; nothing reads them as words."""
    import numpy as np

    ids = [49406] + [(7 * ord(ch) + 3) % 49404 + 1 for ch in prompt][:75] + [49407]
    return np.asarray(ids + [0] * (77 - len(ids)), np.int32)


def http_post(port: int, body: dict, timeout: float = 600.0) -> "tuple[int, dict, float]":
    """(status, reply, seconds) of POST /v1/txt2img."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/txt2img",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), time.time() - t0


def http_get(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def decode_png(reply: dict):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image_png_b64"]))))


def post_all(port: int, bodies: list) -> list:
    """Post every body at once, one thread each; [(status, reply, s)]."""
    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(lambda body: http_post(port, body), bodies))


def sync_sites(fn) -> list:
    """Where `fn` makes a synchronising CUDA call (torch's sync debug mode):
    the file:line of the Python frame of each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def device_gaps(prof) -> "tuple[float, list]":
    """(device idle share of the profiled window, the idle ms after each
    device-to-host copy): the engine's batches end in the uint8 result's
    DtoH copy, so the gap after one is the device's wait between batches."""
    from torch.autograd import DeviceType

    acts = sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    busy, run_start, run_end, gaps = 0, acts[0][0], acts[0][1], []
    for i, (s, e, name) in enumerate(acts):
        if s > run_end:
            busy += run_end - run_start
            run_start, run_end = s, e
        else:
            run_end = max(run_end, e)
        if "DtoH" in name and i + 1 < len(acts):
            gaps.append(max(0, acts[i + 1][0] - e) / 1e6)
    busy += run_end - run_start
    return 1.0 - busy / (acts[-1][1] - acts[0][0]), gaps


def serve_args(argv: list):
    from minddiffusion_tpu_torch.cli import serve

    return serve.build_argparser().parse_args(argv)


def phase25(phase5_s: float) -> dict:
    """SD2 serving at the main path's config (512^2, DDIM-50, CFG 9.0, batch
    8, bf16, raw-exp, seeded random weights) built by cli/serve's
    _build_sd_engine with `toy_tokenize`, behind make_server on a thread."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from minddiffusion_tpu_torch.cli import serve
    from minddiffusion_tpu_torch.serving import make_server

    engine, desc = serve._build_sd_engine(
        serve_args(["--family", "sd2", "--batch_size", str(SERVE_BATCH)]), toy_tokenize)
    adapter = engine.adapter
    engine.start()
    srv = make_server(engine, "127.0.0.1", 0, info={"family": "sd2", "config": desc})
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        warm = http_post(port, {"prompt": "warm", "seed": 0})
        # one dispatch straight through the idle engine's adapter, under
        # torch's sync debug mode
        rows = [adapter.prepare(SERVE_PROMPT, "", s) for s in range(SERVE_BATCH)]
        assert sync_sites(lambda: torch.ones(1, device="cuda").item()), "sync detector is blind"
        syncs = sync_sites(lambda: adapter.dispatch(rows))
        torch.cuda.synchronize()
        assert not syncs, f"dispatch waits on the device at {syncs}"
        reset_counts()
        batches0 = engine.batches_run
        solo = http_post(port, {"prompt": SERVE_PROMPT, "seed": 7})
        bodies = [{"prompt": f"request {i}", "seed": 100 + i, "negative_prompt": "blurry"}
                  for i in range(11)]
        bodies.insert(5, {"prompt": SERVE_PROMPT, "seed": 7})
        replies = post_all(port, bodies)
        counts, batches = read_counts(), engine.batches_run - batches0
        health = http_get(port, "/healthz")
        for status, reply, _ in [warm, solo] + replies:
            assert status == 200, reply
            assert decode_png(reply).shape == (512, 512, 3)
        co = decode_png(replies[5][1])
        assert np.array_equal(co, decode_png(solo[1])), "co-batched request differs from solo"
        assert not np.array_equal(decode_png(replies[0][1]), decode_png(replies[1][1]))
        assert health["requests_served"] == 14 == engine.requests_served, health
        expected = {k: batches * (501 if k == "packed_attention" else
                                  1050 if k == "winograd" else 0) for k in KERNELS}
        assert counts == expected, (counts, expected)
        latencies = sorted(s for _, _, s in replies)
        png_ms = host_ms(lambda: encode_png(co))

        # saturation: 3 full batches back to back, straight into the engine
        n = 3 * SERVE_BATCH
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            with ThreadPoolExecutor(n) as pool:
                imgs = list(pool.map(lambda i: engine.submit(f"load {i}", "", 1000 + i,
                                                             timeout=600), range(n)))
            wall = time.time() - t0
        idle, gaps = device_gaps(prof)
        assert all(img.shape == (512, 512, 3) for img in imgs)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    log(f"[phase 25] serve sd2 {desc} b{SERVE_BATCH} over HTTP: 14 requests, 13 of them in "
        f"{batches} counted batches, launches={counts} (batches x K1 501, K2 1050), "
        f"co-batched == solo, "
        f"p50_latency_s={statistics.median(latencies):.3f} max_latency_s={latencies[-1]:.3f} "
        f"solo_s={solo[2]:.3f} png_encode_ms={png_ms:.2f} synchronising calls in "
        f"dispatch: {len(syncs)}")
    log(f"[phase 25] saturation: {n} requests, 3 batches in {wall:.3f} s: "
        f"s_per_batch={wall / 3:.3f} (phase 5: {phase5_s:.3f}) img_per_s={n / wall:.4f} "
        f"device_idle_share={idle:.4f} gaps_after_each_batch_ms="
        + ",".join(f"{g:.3f}" for g in gaps))
    del engine, adapter
    torch.cuda.empty_cache()
    return counts


def encode_png(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def host_ms(fn, runs: int = 3) -> float:
    """Median host ms of `fn` (host work, no device)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase26() -> dict:
    """GLIDE serving. (i) in-process: cli/serve's _build_glide_engine at batch
    8 with the placeholder tokens (no sentencepiece model in the
    repository), the default cascade to the SRGAN, behind make_server;
    row_seeds invariance and launch counts. (ii) the entry point itself:
    `python -m minddiffusion_tpu_torch.cli.serve --family glide` in a
    subprocess answers one request and stops on SIGTERM."""
    import numpy as np

    from minddiffusion_tpu_torch.cli import serve
    from minddiffusion_tpu_torch.serving import make_server

    engine, desc = serve._build_glide_engine(
        serve_args(["--family", "glide", "--batch_size", str(SERVE_BATCH)]))
    engine.start()
    srv = make_server(engine, "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        reset_counts()
        solo = http_post(port, {"prompt": "一只猫", "seed": 7})
        bodies = [{"prompt": f"请求 {i}", "seed": 200 + i} for i in range(SERVE_BATCH - 1)]
        bodies.insert(3, {"prompt": "一只猫", "seed": 7, "negative_prompt": "模糊"})
        t0 = time.time()
        replies = post_all(port, bodies)
        batch_s = time.time() - t0
        counts, batches = read_counts(), engine.batches_run
        for status, reply, _ in [solo] + replies:
            assert status == 200, reply
            assert decode_png(reply).shape == (1024, 1024, 3)
        assert replies[3][1]["ignored"] == ["negative_prompt"]
        co = decode_png(replies[3][1])
        assert np.array_equal(co, decode_png(solo[1])), "row_seeds: co-batched != solo"
        assert not np.array_equal(decode_png(replies[0][1]), co)
        expected = {k: batches * (555 if k == "packed_attention" else
                                  1692 if k == "winograd" else 0) for k in KERNELS}
        assert counts == expected, (counts, expected)
        png_ms = host_ms(lambda: encode_png(co))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    log(f"[phase 26] serve glide {desc} b{SERVE_BATCH}: {len(bodies) + 1} requests in "
        f"{batches} batches, launches={counts} (batches x K1 555, K2 1692), row_seeds "
        f"co-batched == solo, solo_s={solo[2]:.3f} s_per_batch={batch_s:.3f} "
        f"png_encode_1024_ms={png_ms:.2f} (x8 per batch on the handler threads)")
    del engine
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minddiffusion_tpu_torch.cli.serve", "--family", "glide",
         "--batch_size", "2", "--host", "127.0.0.1", "--port", "0"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout],
                     daemon=True).start()
    try:
        port, seen = None, []
        while port is None:
            try:
                seen.append(lines.get(timeout=max(1.0, t0 + 300 - time.time())))
            except queue.Empty:
                raise AssertionError("serve CLI not listening after 300 s:\n"
                                     + "".join(seen[-20:])) from None
            if "listening on" in seen[-1]:
                port = int(seen[-1].rsplit(":", 1)[1])
        ready_s = time.time() - t0
        status, reply, req_s = http_post(port, {"prompt": "一只猫", "seed": 3})
        assert status == 200 and decode_png(reply).shape == (1024, 1024, 3)
        health = http_get(port, "/healthz")
        assert health["requests_served"] == 2, health   # its warm-up and this request
    finally:
        proc.terminate()
        code = proc.wait(timeout=60)
    log(f"[phase 26] cli/serve --family glide --batch_size 2 in a subprocess: listening "
        f"after {ready_s:.1f} s, one request 200 (1024x1024 PNG) in {req_s:.3f} s, "
        f"healthz={health}, exit code after SIGTERM {code}")
    return counts


# ---- K10 / K11 (phase 27) ---------------------------------------------------

VARIANT_CASES = [  # (label, B, Nq, Nk, C, exact): K10a, K10b and K10d
    ("ds1_16x4096x320", 16, 4096, 4096, 320, False),
    ("ds2_16x1024x640", 16, 1024, 1024, 640, False),
    ("ds2_16x1024x640_exact", 16, 1024, 1024, 640, True),
    ("ragged_nq1000_nk77", 8, 1000, 77, 320, True),
    ("nk_nq_plus_128", 16, 1024, 1152, 384, True),
]
PROJ_CASES = [("ds1_16x4096x320", 16, 4096, 320, False), ("ds2_16x1024x640", 16, 1024, 640, False),
              ("ds2_16x1024x640_exact", 16, 1024, 640, True)]
OUT_EXTRA_CASES = [("ds2_c640_to_c320", 16, 1024, 1024, 640, False, 320),
                   # K11's ds4 shape: the out kernel's 64-row tier (C > 640)
                   ("ds4_16x256x1280", 16, 256, 256, 1280, True, 1280)]
# the kernels of attn_variants.cu that must run wgmma and no mma.sync, and
# those of them (on the attention core) whose ptxas report must show no spills
WGMMA_KERNELS = ("attn_out_kernel", "qkv_proj_kernel", "attn_ones_kernel")
CORE_KERNELS = ("attn_out_kernel", "attn_ones_kernel")
ONES_KERNELS = ("attn_ones", "attn_fold", "ones_attention")
K11_CASES = [  # bench_attention.py:111-113 (exact, as its main runs `ones`), a ragged Nq
    ("ds1_16x4096x320", 16, 4096, 4096, 320, True),
    ("ds2_16x1024x640", 16, 1024, 1024, 640, True),
    ("ds4_16x256x1280", 16, 256, 256, 1280, True),
    ("ds1_16x4096x320_fast", 16, 4096, 4096, 320, False),
    ("ragged_nq4000", 2, 4000, 4000, 320, False),
]
VARIANT_SOURCE = "minddiffusion_tpu_torch/ops/csrc/attn_variants.cu"
VARIANT_REPLACES = {
    "attn_ones": "benchmarks/research/attn_variants.py:86",
    "attn_fold": "benchmarks/research/attn_variants.py:183",
    "attn_proj": "benchmarks/research/attn_variants.py:292",
    "attn_out": "benchmarks/research/attn_variants.py:386",
    "ones_attention": "benchmarks/bench_attention.py:76",
}


def variant_bound(b: int, nq: int, nk: int, c: int, proj_flops: float = 0.0,
                  nbytes: "float | None" = None) -> "tuple[float, str, str]":
    """attention_bound at D 64 with the projections' bf16 flops added to the
    tensor-core term; `nbytes` replaces the HBM term's bytes (q, k, v read
    and the output written once, in bf16) where the inputs differ."""
    return attention_bound(b, c // 64, nq, nk, 64, proj_flops, nbytes)


def phase27(gen: torch.Generator, table: dict) -> None:
    """K10a-d and K11 against their plain versions at the SD2 UNet's ds1 and
    ds2 self-attention shapes and bench_attention.py's, with a ragged Nq,
    Nk 77 and Nk = Nq + 128, C_out != C, K10d at C 1280, both softmax
    modes; beside SDPA (K10a, K10b, K11), the unfused chain (K10c: three
    input projections + SDPA + the output projection; K10d: SDPA + the
    output projection) and K1 at the same shape where K1 takes it; then the
    SASS check of the K10c / K10d kernels. No path of
    either package launches them."""
    from minddiffusion_tpu_torch.ops import attn_variants as av, flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def grid(name):
        """(CTAs, waves) of the case's attention launch as its launcher
        reported them: the out kernel (K10c's second launch, K10d) and the
        ones kernel hold one CTA an SM (their q tile and ring)."""
        ctas = av.last_ctas["mdt_attn_out" if name in ("attn_out", "attn_proj")
                            else "mdt_attn_ones"]
        return ctas, ctas / sms

    def run_case(name, label, b, nq, nk, c, exact, kernel_fn, plain_fn, library_fn,
                 k1_fn, bnd, extra=None):
        ref = plain_fn()
        av.last_ctas.clear()
        got = kernel_fn()
        torch.cuda.synchronize()
        ctas, waves = grid(name)
        assert torch.isfinite(got.float()).all(), (name, label)
        abs_err, err = errors(got, ref)
        del ref
        ms = cuda_ms(kernel_fn)
        plain_ms = cuda_ms(plain_fn, runs=3)
        library_ms = cuda_ms(library_fn, runs=5)
        k1_ms = cuda_ms(k1_fn, runs=5) if k1_fn is not None else None
        bound_ms, bound_by, term = bnd
        extra = dict(extra or {})
        if name in ONES_KERNELS:   # the plan and the kernel's device time
            extra["plan"] = lambda: av.ones_plan(b, nq, c, c // 64)
            extra["device_ms"] = lambda: device_ms(kernel_fn, "attn_ones_kernel")
        extra = {k: f() for k, f in extra.items()}
        log(f"[phase 27] {name} {label} B={b} Nq={nq} Nk={nk} C={c} exact={exact} "
            f"max_abs_err={abs_err:.3e} rel_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"k1_ms={'n/a' if k1_ms is None else f'{k1_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({term}) ctas={ctas} "
            f"waves={'n/a' if waves is None else f'{waves:.2f}'}"
            + "".join(f" {k}={fmt_ms(v) if k == 'device_ms' else v}" for k, v in extra.items()))
        assert err <= REL_TOL, (name, label, err)
        table[name]["cases"].append(
            dict(case=label, abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bound_term=term, k1_ms=k1_ms, ctas=ctas, waves=waves, **extra))

    def sdpa(q, k, v, heads, scale):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        views = [t.view(t.shape[0], -1, heads, 64).transpose(1, 2) for t in (q, k, v)]

        def call():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                o = F.scaled_dot_product_attention(*views, scale=scale)
            return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)
        return call

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for label, b, nq, nk, c, exact, *c_out in (VARIANT_CASES + OUT_EXTRA_CASES):
        heads, scale = c // 64, 0.125
        q, k, v = (randn(b, n, c).to(torch.bfloat16) for n in (nq, nk, nk))
        attn = sdpa(q, k, v, heads, scale)
        k1 = ((lambda: fa.flash_attention_packed(q, k, v, heads, scale, exact))
              if fa.kernel_supports(q, k, heads) else None)
        att = variant_bound(b, nq, nk, c)
        if not c_out:
            for name, fn in (("attn_ones", av.flash_attention_packed_ones),
                             ("attn_fold", av.flash_attention_packed_fold)):
                run_case(name, label, b, nq, nk, c, exact,
                         lambda fn=fn: fn(q, k, v, scale, heads, exact),
                         lambda: av.attn_ones_plain(q, k, av.augment_v(v, heads), scale,
                                                    heads, exact), attn, k1, att)
        co = c_out[0] if c_out else c
        wo = (randn(c, co) * c ** -0.5).to(torch.bfloat16)
        bo = 0.1 * randn(co)
        run_case("attn_out", label, b, nq, nk, c, exact,
                 lambda: av.flash_attention_packed_out(q, k, v, wo, bo, scale, heads, exact),
                 lambda: av.attn_out_plain(q, k, v, wo, bo, scale, heads, exact),
                 lambda: F.linear(attn(), wo.T, bo.to(torch.bfloat16)), k1,
                 variant_bound(b, nq, nk, c, 2.0 * b * nq * c * co,
                               2.0 * b * (nq * c + 2 * nk * c + nq * co) + 2.0 * c * co
                               + 4.0 * co))
        del q, k, v
        torch.cuda.empty_cache()

    for label, b, n, c, exact in PROJ_CASES:
        heads, scale = c // 64, 0.125
        x = randn(b, n, c).to(torch.bfloat16)
        wq, wk, wv, wo = ((randn(c, c) * c ** -0.5).to(torch.bfloat16) for _ in range(4))
        bo = 0.1 * randn(c)
        args = (x, wq, wk, wv, wo, bo, scale, heads)
        wqs = (wq.float() * scale).to(torch.bfloat16)
        bo16 = bo.to(torch.bfloat16)

        def chain():
            q, k, v = (torch.matmul(x, w) for w in (wqs, wk, wv))
            return F.linear(sdpa(q, k, v, heads, 1.0)(), wo.T, bo16)

        y = av._proj_qkv(x, wq, wk, wv, scale)
        run_case("attn_proj", label, b, n, n, c, exact,
                 lambda: av.flash_attention_packed_proj(*args, exact=exact),
                 lambda: av.attn_proj_plain(*args, exact), chain, None,
                 variant_bound(b, n, n, c, 8.0 * b * n * c * c,
                               4.0 * b * n * c + 8.0 * c * c + 4.0 * c),
                 # the two launches apart: the GEMM (persistent, at most one
                 # CTA an SM), then the attention with the Wo epilogue
                 extra={"gemm_ms": lambda: round(cuda_ms(
                            lambda: av._proj_qkv(x, wq, wk, wv, scale)), 4),
                        "attn_ms": lambda: round(cuda_ms(
                            lambda: av._proj_attend(y, wo, bo, heads, exact)), 4),
                        "gemm_ctas": lambda: av.last_ctas["mdt_qkv_proj"],
                        "gemm_bound_ms": lambda: round(bound(
                            6.0 * b * n * c * c, 2.0 * b * n * c * 4 + 6.0 * c * c)[0], 4)})
        del x, y
        torch.cuda.empty_cache()

    for label, b, nq, nk, c, exact in K11_CASES:
        heads, scale = c // 64, 0.125
        q, k, v = (randn(b, n, c).to(torch.bfloat16) for n in (nq, nk, nk))
        run_case("ones_attention", label, b, nq, nk, c, exact,
                 lambda: av.ones_attention(q, k, v, scale, heads, exact),
                 lambda: av.attn_ones_plain(q, k, av.augment_v(v, heads), scale, heads,
                                            exact),
                 sdpa(q, k, v, heads, scale),
                 (lambda: fa.flash_attention_packed(q, k, v, heads, scale, exact))
                 if fa.kernel_supports(q, k, heads) else None,
                 variant_bound(b, nq, nk, c))
        del q, k, v
        torch.cuda.empty_cache()
    hold_wgmma_sass("attn_variants", WGMMA_KERNELS, "phase 27", spills=CORE_KERNELS)


SASS_REPORTS: dict = {}   # csrc source -> scripts/ptxas_report.py's report, as held


def hold_wgmma_sass(source: str, kernels, phase: str, spills=()) -> None:
    """ptxas -v of csrc/<source>.cu (registers, spills) and the tensor-core
    lines in the SASS of each kernel: every instantiation of `kernels` runs
    wgmma (HGMMA) and no mma.sync (HMMA), and none of `spills` (kernel
    names; True: all of `kernels`) spills. Keeps the report in
    SASS_REPORTS."""
    report = run([sys.executable, str(Path(__file__).resolve().parent / "scripts" /
                                      "ptxas_report.py"), source])
    SASS_REPORTS[source] = report
    for line in report.splitlines():
        log(f"[{phase}] {line}")
    for kname in kernels:
        rows = [ln for ln in report.splitlines() if kname in ln and "SASS lines" in ln]
        assert rows, (kname, "not in the SASS")
        for ln in rows:
            hgmma, hmma = (int(x) for x in re.search(r"HGMMA (\d+), HMMA (\d+)", ln).groups())
            assert hgmma > 0 and hmma == 0, ln
            if spills is True or kname in spills:
                assert re.search(r"spills 0$", ln), ln


# K1's and K10d's registers a thread (ptxas -v) before K12 and the ones
# kernel joined their core, which they must keep: (source, kernel, template
# arguments)
CORE_REGISTERS = {
    ("attn_variants", "attn_out_kernel", (1,)): 129,
    ("attn_variants", "attn_out_kernel", (2,)): 168,
    ("attn_variants", "attn_out_kernel", (3,)): 128,
    ("packed_attention", "packed_attn_kernel", (64, 64, 1)): 129,
    ("packed_attention", "packed_attn_kernel", (64, 64, 2)): 168,
    ("packed_attention", "packed_attn_kernel", (64, 64, 3)): 128,
    ("packed_attention", "packed_attn_kernel", (40, 64, 1)): 113,
    ("packed_attention", "packed_attn_kernel", (40, 64, 2)): 168,
    ("packed_attention", "packed_attn_kernel", (80, 64, 1)): 141,
    ("packed_attention", "packed_attn_kernel", (80, 64, 2)): 168,
    ("packed_attention", "packed_attn_kernel", (160, 32, 1)): 178,
    ("packed_attention", "packed_attn512_kernel", ()): 128,
}


def kernel_registers(report: str) -> dict:
    """{(kernel, integer template arguments): registers} of a ptxas report's
    per-kernel lines: the kernel's name is the mangled name's identifier
    ending in `_kernel` (length-prefixed: `15attn_out_kernel`), its
    arguments the literals after it (`ILi64ELi64ELi3EE` -> (64, 64, 3);
    bools as 0 / 1)."""
    out = {}
    for ln in report.splitlines():
        m = re.search(r": (\S+): SASS lines .* registers (\d+),", ln)
        if not m:
            continue
        mangled, pos = m.group(1), len("_ZN")
        while (length := re.match(r"\d+", mangled[pos:])):   # <length><identifier>, in turn
            pos += length.end() + int(length.group())
            name = mangled[pos - int(length.group()):pos]
            if name.endswith("_kernel"):
                args = re.findall(r"L[ib](\d+)E", mangled[pos:].split("EE")[0] + "E")
                out[(name, tuple(int(a) for a in args))] = int(m.group(2))
                break
    return out


def hold_core_registers(phase: str) -> None:
    """K1's and K10d's kernels (phases 2 and 27's reports) hold their
    registers (CORE_REGISTERS) with K12 and the ones kernel on their core."""
    for (source, kname, args), want in CORE_REGISTERS.items():
        got = kernel_registers(SASS_REPORTS[source]).get((kname, args))
        log(f"[{phase}] {source}.cu {kname}{list(args)} registers {got} (expected {want})")
        assert got == want, (source, kname, args, got, want)



# ---- K12 (phase 28) ---------------------------------------------------------

DIAG_SOURCE = "minddiffusion_tpu_torch/ops/csrc/attn_diag.cu"
DIAG_ROWS = {  # row: (its wrapper in ops/attn_diag.py, the pallas_call of its TPU kernel)
    **{f"diag_{m}": ("diag", "benchmarks/bench_attn_ds1.py:137")
       for m in ("qk", "exp", "nosm", "fp32pv", "full")},
    "diag_kt_qk": ("diag_kt", "benchmarks/bench_attn_ds1.py:183"),
    "diag_kt_full": ("diag_kt", "benchmarks/bench_attn_ds1.py:183"),
    "diag_qk_slice": ("diag_slice", "benchmarks/bench_attn_ds1.py:218"),
    "diag_qkexp_slice": ("diag_slice", "benchmarks/bench_attn_ds1.py:218"),
    "diag_bf16s": ("diag_bf16s", "benchmarks/bench_attn_ds1.py:266"),
    "diag_bf16s_ex2": ("diag_bf16s", "benchmarks/bench_attn_ds1.py:266"),
}
# SDPA at scale 1 computes softmax(q k^T) v, the function of these modes
# where it is finite (it subtracts the row max, so it never overflows)
DIAG_LIBRARY = ("diag_full", "diag_kt_full", "diag_bf16s", "diag_bf16s_ex2")
# The kernels and the plain versions sum s's 64 products in other orders
# (mma.sync vs cuBLAS) and take exp with other roundings, so s and exp(s)
# differ in their last bits. Two kinds of output turn on those bits: one
# whose fp32 overflow flips (every mode with an exp, on the script's input),
# and, in bf16s, one whose row leans on a score at a bf16 rounding midpoint
# (bf16(s) jumps by a bf16 step there, exp(bf16(s)) by 28% at s ~ 40). The
# plain version is run again with s moved by a relative -2^-16 and +2^-16
# (`attn_diag.BOUNDARY_EPS`, ~100 fp32 ulps, above the 64 u ~ 2^-18 worst
# case of a 64-term fp32 sum). An output may be non-finite where the plain
# one is finite (or the other way) only where one of those moves flips it;
# every output finite in both is held within REL_TOL (of its scale, above)
# plus its allowance: how far the moves took the plain output, and for
# bf16s `attn_diag.bf16s_rounding_bound`.


DIAG_XS = 0.75          # x * 0.75: the script's input with every logit below 88


def max_logit(q: torch.Tensor, k: torch.Tensor, heads: int) -> float:
    d = q.shape[-1] // heads
    return max(torch.matmul(q[i, :, h * d:(h + 1) * d].float(),
                            k[i, :, h * d:(h + 1) * d].float().T).max().item()
               for i in range(q.shape[0]) for h in range(heads))


def hold_diag(name: str, got: torch.Tensor, plain, args: tuple, heads: int,
              overflow: bool, exp_table: "torch.Tensor | None" = None) -> dict:
    """`got` against the plain version on `args` (BOUNDARY_EPS): where
    both are finite, within REL_TOL of the output's scale (`hold_scale`)
    plus its allowance; non-finite where the plain one is, except where the
    plain one's finiteness moves with s's last bits; unless `overflow`,
    finite everywhere in both. bf16s's allowance includes
    `bf16s_rounding_bound` with `exp_table`'s exp."""
    from minddiffusion_tpu_torch.ops.attn_diag import (BOUNDARY_EPS, bf16s_rounding_bound,
                                                      hold_scale)

    ref = plain(*args, heads)
    fin, gfin = torch.isfinite(ref), torch.isfinite(got)
    scale = hold_scale(name, ref, heads)
    allowance = torch.zeros(ref.shape, device=ref.device)
    if name.startswith("diag_bf16s"):
        allowance = bf16s_rounding_bound(*args, heads, exp_table=exp_table)
    flips = torch.zeros_like(fin)
    for e in (-BOUNDARY_EPS, BOUNDARY_EPS):
        moved = plain(*args, heads, score_scale=1.0 + e)
        mfin = torch.isfinite(moved)
        flips |= mfin != fin
        moved = torch.where(mfin & fin, (moved.float() - ref.float()).abs(), 0.0)
        allowance = torch.maximum(allowance, moved)
        del moved, mfin
    if not overflow:
        assert fin.all() and gfin.all(), (name, int((~fin).sum()), int((~gfin).sum()))
    mismatch = gfin != fin
    rec = dict(nonfinite=int((~fin).sum()), flippable=int(flips.sum()),
               mask_mismatches=int(mismatch.sum()))
    assert not (mismatch & ~flips).any(), (name, rec)
    checked = fin & gfin
    diff = torch.where(checked, (got.float() - ref.float()).abs(), 0.0)
    limit = REL_TOL * scale + allowance
    # the error against its scale, after the allowance: <= REL_TOL passes
    excess = torch.where(checked, (diff - allowance).clamp_min(0.0) / scale, 0.0)
    excess = torch.nan_to_num(excess, nan=0.0, posinf=math.inf)   # 0 / 0 where diff is 0
    sensitive = checked & (allowance > 0.5 * REL_TOL * scale)
    rec.update(
        sensitive=int(sensitive.sum()),
        rel_err=excess.max().item(),
        # the same without the allowance, over every output finite in both,
        # and over the sensitive ones alone
        rel_err_raw=torch.nan_to_num(torch.where(checked, diff / scale, 0.0)).max().item(),
        err_sensitive=(torch.nan_to_num(diff / scale)[sensitive].max().item()
                       if sensitive.any() else 0.0),
        outputs_over_limit=int((checked & (diff > limit)).sum()))
    assert rec["outputs_over_limit"] == 0 and rec["rel_err"] <= REL_TOL, (name, rec)
    return dict(abs_err=diff.max().item(), **rec)


def hold_exp_table(table: torch.Tensor) -> dict:
    """The packed bf16 exp of bf16s_ex2 at every finite bf16 input against
    torch.exp rounded to bf16: the largest relative error where the exact
    value is a normal finite bf16; finite exactly where it is; zero where it
    is and where it is subnormal (flushed), nowhere else."""
    x = torch.arange(1 << 16, dtype=torch.int32, device=table.device).to(torch.int16).view(
        torch.bfloat16)
    ok = torch.isfinite(x)
    exact, got = torch.exp(x.float()).to(torch.bfloat16).float(), table.float()
    normal = ok & torch.isfinite(exact) & (exact >= torch.finfo(torch.bfloat16).tiny)
    rel = ((got - exact).abs() / exact)[normal].max().item()
    zero = ok & ((got == 0) != (exact == 0))
    rec = dict(max_rel_err=rel,
               finite_mismatches=int((ok & (torch.isfinite(got) != torch.isfinite(exact))).sum()),
               flushed=int((zero & ~normal).sum()), zero_mismatches=int((zero & normal).sum()))
    # ex2.approx.ftz.bf16x2's own error plus bf16(f)'s 2^-9 step: a few bf16 ulps
    assert rel <= 2e-2 and rec["finite_mismatches"] == 0 and rec["zero_mismatches"] == 0, rec
    return rec


def phase28(gen: torch.Generator, table: dict) -> None:
    """K12's ten modes and bf16s_ex2 against their plain versions at
    bench_attn_ds1.py's shape, on three inputs: independent randn q, k, v
    (the timed case), the script's x (q = k = v) scaled by DIAG_XS, and x
    itself (its rows whose diagonal logit passes 88 overflow in both
    versions); beside K1 raw-exp and SDPA flash at scale 1. bf16s_ex2's
    plain version takes the packed exp's values (`exp_bf16x2_table`), which
    are held against torch.exp first; the kernel is also compared with the
    exact-exp plain version, its overflow positions counted. Then the
    shootout over every variant. No path of either package launches K12."""
    from minddiffusion_tpu_torch.bench import attn_ds1
    from minddiffusion_tpu_torch.ops import attn_diag as ad, flash_attention as fa

    b, n, c, heads = attn_ds1.B, attn_ds1.N, attn_ds1.C, attn_ds1.H
    d = c // heads
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    indep = tuple(torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    x = attn_ds1.script_input(b, n, c, "cuda")
    xs = (x.float() * DIAG_XS).to(torch.bfloat16)
    xh = x.float().view(b, n, heads, d)
    diag_logits = (xh * xh).sum(-1)           # q = k: the largest logit of each row
    limits = dict(indep=max_logit(indep[0], indep[1], heads),
                  scaled=diag_logits.max().item() * DIAG_XS ** 2,
                  script=diag_logits.max().item(),
                  script_rows_over_88=int((diag_logits > 88.7228).sum()))
    assert limits["indep"] < 88 and limits["scaled"] < 88, limits
    log(f"[phase 28] inputs: max logit {limits}")
    k1_ms = cuda_ms(lambda: fa.flash_attention_packed(*indep, heads, 1.0, False))
    views = [t.view(b, n, heads, d).transpose(1, 2) for t in indep]
    library_ms, backend = sdpa_ms(*views, 1.0)
    exp_table = ad.exp_bf16x2_table(torch.device("cuda"))
    table_rec = hold_exp_table(exp_table)
    log(f"[phase 28] packed bf16 exp vs torch.exp at all 65536 bf16 inputs: {table_rec}")
    for name, (fn, plain) in ad.variants().items():
        ex2 = name == "diag_bf16s_ex2"
        cases, vs_exact = {}, {}
        for label, args, overflow in (("ds1_16x4096x320", indep, False),
                                      ("script_x0.75", (xs, xs, xs), False),
                                      ("script_x", (x, x, x), True)):
            got = fn(*args, heads)
            torch.cuda.synchronize()
            cases[label] = hold_diag(name, got, plain, args, heads, overflow,
                                     exp_table if ex2 else None)
            if ex2:   # the same kernel against the function with torch.exp
                ref = ad.diag_bf16s_plain(*args, heads)
                fin, gfin = torch.isfinite(ref), torch.isfinite(got)
                both = fin & gfin
                vs_exact[label] = dict(
                    mask_mismatches=int((fin != gfin).sum()),
                    rel_err=((got.float() - ref.float())[both].abs().max()
                             / ref.float()[both].abs().max()).item())
                del ref, fin, gfin, both
            del got
        ms = cuda_ms(lambda: fn(*indep, heads))
        plan = ad.diag_plan(ad.PLAN_MODES[name], b, n, c, heads)
        ad.last_ctas.clear()
        fn(*indep, heads)
        torch.cuda.synchronize()
        ctas = next(iter(ad.last_ctas.values()))
        dev_ms = device_ms(lambda: fn(*indep, heads), "diag_kernel")
        plain_ms = cuda_ms(lambda: plain(*indep, heads), runs=3)
        bound_ms, bound_by, term = attn_ds1.bound(name, b, n, c, heads, CARD["exp_per_s"])
        lib = library_ms if name in DIAG_LIBRARY else None
        mask = cases["script_x"]
        log(f"[phase 28] {name} B={b} N={n} C={c} heads={heads} "
            + " ".join(f"{lab}:rel_err={r['rel_err']:.3e},raw={r['rel_err_raw']:.3e},"
                       f"sensitive={r['sensitive']},err_sensitive={r['err_sensitive']:.3e}"
                       for lab, r in cases.items())
            + f" script_x:nonfinite={mask['nonfinite']},flippable={mask['flippable']},"
            f"mask_mismatches={mask['mask_mismatches']} "
            + (f"vs_exact_exp={vs_exact} " if ex2 else "") + f"plan(rows, stages, groups)={plan} "
            f"ctas={ctas} waves={ctas / sms:.2f} kernel_ms={ms:.4f} device_ms={fmt_ms(dev_ms)} "
            f"plain_ms={plain_ms:.4f} k1_fast_ms={k1_ms:.4f} "
            f"library_ms={'none' if lib is None else f'{lib:.4f} (sdpa {backend})'} "
            f"bound_ms={bound_ms:.4f} ({term})")
        for label, r in cases.items():
            table[name]["cases"].append({
                "case": label, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": lib, "plan": plan, "ctas": ctas,
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_term": term,
                "k1_ms": k1_ms, "holds": {lab: {k: h[k] for k in (
                    "rel_err", "rel_err_raw", "sensitive", "err_sensitive", "nonfinite",
                    "flippable", "mask_mismatches")} for lab, h in cases.items()},
                **({"vs_exact_exp": vs_exact, "exp_table": table_rec} if ex2 else {}), **r})
    del indep, x, xs, xh, diag_logits
    torch.cuda.empty_cache()
    results = attn_ds1.main([])
    assert [r["name"] for r in results] == list(attn_ds1.VARIANTS)
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in results)
    hold_wgmma_sass("attn_diag", ("diag_kernel",), "phase 28", spills=True)
    hold_core_registers("phase 28")


# ---- eval and export (phases 29, 30) ----------------------------------------

def phase29(images: torch.Tensor) -> None:
    """The eval path at full width: CLIPScoreConfig.vit_h14 (fp32, seeded
    random weights; no CLIP checkpoint is in the repository) scores phase
    5's images against phase 5's tokens, twice; CLIP-FID between the two
    halves of the batch; the time per image."""
    from minddiffusion_tpu_torch.eval import (CLIPScoreConfig, clip_fid, clip_score_fn,
                                              image_features_fn)

    cfg = CLIPScoreConfig.vit_h14()
    scorer, score = clip_score_fn(cfg, "cuda", torch.Generator(device="cuda").manual_seed(5))
    b = images.shape[0]
    tokens = torch.ones(b, 77, dtype=torch.long)      # the prompt tokens phase 5 ran with

    def run():
        out = score(scorer, images, tokens)
        torch.cuda.synchronize()
        return out

    first, second = run(), run()
    assert first.shape == (b,) and torch.isfinite(first).all(), first
    assert first.abs().max().item() <= 100.0 + 1e-3, first
    assert torch.equal(first, second), (first, second)
    feats = image_features_fn(cfg, "cuda")(scorer, images)
    fid = clip_fid(feats[: b // 2], feats[b // 2:])
    assert math.isfinite(fid) and fid >= 0.0, fid
    ms = host_ms(run)
    log(f"[phase 29] clip_score vit_h14 fp32 B={b} 512x512->224 scores="
        f"{[round(v, 4) for v in first.tolist()]} rerun_equal=True clip_fid_halves={fid:.6f} "
        f"ms_per_batch={ms:.3f} ms_per_image={ms / b:.3f} card='{CARD['smi']}'")
    del scorer
    torch.cuda.empty_cache()


def phase30(tmp: str) -> None:
    """Export at full width: SD2 random weights (bf16, written as BF16
    .safetensors) -> `cli/export_weights` (fp32 .safetensors) ->
    `cli.common.build_sd`; the state dicts and one UNet eval bitwise equal,
    and the serve CLI's `check_ckpt` takes the file."""
    from minddiffusion_tpu_torch.cli import common, export_weights, serve
    from minddiffusion_tpu_torch.io import sd_weights

    gen = torch.Generator(device="cuda").manual_seed(9)
    models = sd2_models(gen)
    src, out = os.path.join(tmp, "sd2_bf16.safetensors"), os.path.join(tmp, "sd2.safetensors")
    t0 = time.time()
    sd_weights.save_safetensors(models.state_dict(), src)
    t1 = time.time()
    export_weights.main(["--family", "sd2", "--ckpt", src, "--out", out])
    t2 = time.time()
    serve.check_ckpt(out)
    back = common.build_sd("sd2", "bf16", torch.device("cuda"), ckpt_path=out)
    t3 = time.time()
    before, after = models.state_dict(), back.state_dict()
    assert before.keys() == after.keys()
    differ = [k for k in before if not torch.equal(before[k], after[k])]
    assert not differ, differ[:5]
    x = torch.randn(16, 64, 64, 4, generator=gen, device="cuda")
    t = torch.linspace(1, 981, 16, device="cuda").round().long()
    ctx = torch.randn(16, 77, 1024, generator=gen, device="cuda")
    with torch.inference_mode():
        eps_a = models.unet(x, t, ctx)
        eps_b = back.unet(x, t, ctx)
    torch.cuda.synchronize()
    assert torch.equal(eps_a, eps_b), (eps_a - eps_b).abs().max().item()
    log(f"[phase 30] export sd2: {len(before)} tensors, bf16 file "
        f"{os.path.getsize(src) / 1e9:.3f} GB written in {t1 - t0:.1f} s, export to fp32 "
        f"{os.path.getsize(out) / 1e9:.3f} GB in {t2 - t1:.1f} s, build_sd read back in "
        f"{t3 - t2:.1f} s; state dicts and one UNet eval (B 16, 64x64) bitwise equal; "
        f"check_ckpt took it")
    del models, back
    torch.cuda.empty_cache()

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {
        "packed_attention": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/packed_attention.cu",
            replaces="minddiffusion_tpu/ops/flash_attention.py:235", cases=[]),
        "winograd": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/winograd.cu",
            replaces="minddiffusion_tpu/ops/winograd.py:467", cases=[]),
        "flash_attention": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/flash_attention.cu",
            replaces="minddiffusion_tpu/ops/flash_attention.py:124", cases=[]),
        "winograd_gathered": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/winograd.cu",
            replaces="minddiffusion_tpu/ops/winograd.py:494", cases=[]),
        "glide_tail": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/glide_tail.cu",
            replaces="benchmarks/research/glide_tail.py:282", cases=[], held_in_phase=16),
        "channel_sums": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/gn_stats.cu",
            replaces="benchmarks/research/gn_stats.py:87", cases=[], held_in_phase=17),
        "fused_ff": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/fused_ff.cu",
            replaces="benchmarks/research/fused_ff.py:127", cases=[], held_in_phase=18),
        "conv3x3_v1": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/conv3x3.cu",
            replaces="benchmarks/research/conv3x3.py:90", cases=[], held_in_phase=21),
        "conv3x3_gemm": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/conv3x3.cu",
            replaces="benchmarks/research/conv3x3.py:286", cases=[], held_in_phase=21),
        "winograd43": dict(
            route="cuda", source="minddiffusion_tpu_torch/ops/csrc/winograd43.cu",
            replaces="benchmarks/research/winograd43.py:203", cases=[], held_in_phase=22),
        **{kname: dict(route="cuda", source=VARIANT_SOURCE, replaces=replaces, cases=[],
                       held_in_phase=27) for kname, replaces in VARIANT_REPLACES.items()},
        **{kname: dict(route="cuda", source=DIAG_SOURCE, replaces=replaces, cases=[],
                       held_in_phase=28) for kname, (_, replaces) in DIAG_ROWS.items()},
    }
    name = phase0()
    phase1()
    phase2(gen, table)
    phase3(gen, table)
    phase4(gen)
    main_counts, phase5_s, phase5_images = phase5()
    by_path = {"txt2img_512_ddim50_b8": main_counts}
    phase6(gen, table)
    models = sd2_models(torch.Generator(device="cuda").manual_seed(2))
    by_path["txt2img_768x1024_ddim50_b4"] = phase7(models)
    by_path["img2img_768_s075_ddim50_b4"] = phase8(models)
    by_path["txt2img_512_dpm20_b8"] = phase9(models)
    del models
    torch.cuda.empty_cache()
    phase10(gen, table)
    phase11(gen)
    by_path["wukong_txt2img_512_dpm15_b4"] = phase12()
    by_path["wukong_inpaint_512_plms50_b4_dma0"] = phase13()
    glide = glide_models()
    phase14(glide, gen)
    by_path["glide_cascade_b8"], img64 = phase15(glide)
    phase16(glide, img64, gen, table)
    del glide
    torch.cuda.empty_cache()
    phase17(gen, table)
    phase18(gen, table)
    by_path["sd2_finetune_512_b3"] = phase19(gen)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["wukong_lora_512_b3_3steps"], by_path["wukong_dreambooth_512_b3_1step"] = \
            phase20(tmp)
    phase21(gen, table)
    phase22(gen, table)
    by_path.update(phase23(gen))
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase24(tmp))
    by_path["serve_sd2_512_ddim50_b8"] = phase25(phase5_s)
    by_path["serve_glide_cascade_b8"] = phase26()
    phase27(gen, table)
    phase28(gen, table)
    phase29(phase5_images)
    with tempfile.TemporaryDirectory() as tmp:
        phase30(tmp)
    kernels = []
    for kname, rec in table.items():
        main_case = next(c for c in rec["cases"] if c["case"] == MAIN_CASE[kname])
        runs = {p: counts[kname] for p, counts in by_path.items()}
        # launches: on the first path that runs the kernel (the 512^2 main
        # path for K1 and K2, the 768x1024 path for K4, path B for K3; 0 for
        # K5-K12, which no path runs and `held_in_phase` holds); every path's
        # count is in launches_by_path, and each was checked above
        launches = next((n for n in runs.values() if n), 0)
        extra = {k: rec[k] for k in ("held_in_phase",) if k in rec}
        for key in ("unfused_ms", "direct_conv_rel_l2", "k1_ms", "holds", "gemm_ms",
                    "attn_ms", "device_ms"):
            if key in main_case:
                extra[key] = main_case[key]
        kernels.append(dict(
            name=kname, route=rec["route"], source=rec["source"],
            replaces=rec["replaces"], launches=launches,
            max_abs_err=max(c["abs_err"] for c in rec["cases"]),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], case=main_case["case"],
            bound_term=main_case.get("bound_term", "mma" if main_case["bound_by"]
                                     == "operations" else "bytes"),
            launches_by_path=runs, **extra))
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
