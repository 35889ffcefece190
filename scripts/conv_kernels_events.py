"""Time the two conv kernels of the port, K7 (`ops/conv3x3.py`, csrc/conv3x3.cu)
and K8 (`ops/winograd43.py`, csrc/winograd43.cu), by CUDA events around
whole wrapper calls (the wrapper's host time in them, as chip_smoke.py
times them), beside cuDNN's bf16 channels-last conv on the same tensors:
K7 v1 at chip_smoke phase 21's eight shapes (C -> C), v2 with the fused
GN-affine + SiLU prologue and residual at its two (beside the unfused
chain), K8 with U hoisted at phase 22's five.

    python3 scripts/conv_kernels_events.py [--root DIR]

`--root DIR` imports the package from DIR (another checkout, e.g. the
parent commit's unpacked with `git archive`, built from its own sources),
so two commits are compared on one card in one call: run parent, change,
change, parent. Each line: the case, the kernel's median ms over 7 calls
after 2 warm-ups, cuDNN's (or the chain's), and the card with its power
limit, and the host microseconds a call of each takes to return (its
launches queued). Needs one card and the CUDA toolkit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if "--root" in sys.argv:
    ROOT = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from minddiffusion_tpu_torch.ops import conv3x3 as cv, winograd43 as w43  # noqa: E402

CONV_CASES = [  # chip_smoke.CONV_CASES: (label, B, H, W, C), C -> C
    ("unet_64x64_320", 16, 64, 64, 320), ("unet_32x32_640", 16, 32, 32, 640),
    ("unet_16x16_1280", 16, 16, 16, 1280), ("unet_8x8_1280", 16, 8, 8, 1280),
    ("vae_64x64_512", 8, 64, 64, 512), ("vae_128x128_512", 8, 128, 128, 512),
    ("vae_256x256_256", 8, 256, 256, 256), ("vae_512x512_128", 8, 512, 512, 128),
]
FUSED_CONV_CASES = [("fused_64x64_320", 16, 64, 64, 320), ("fused_32x32_640", 16, 32, 32, 640)]
WINO43_CASES = [  # chip_smoke.WINO43_CASES: (label, B, H, W, C_in, C_out)
    ("unet_32x32_640", 16, 32, 32, 640, 640), ("vae_128x128_512", 8, 128, 128, 512, 512),
    ("vae_256x256_256", 8, 256, 256, 256, 256), ("vae_512x512_128", 8, 512, 512, 128, 128),
    ("vae_256x256_512_256", 8, 256, 256, 512, 256),
]


def cuda_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 20) -> float:
    """Host microseconds a call takes to return (its launches queued, not
    run): the mean over `calls` calls without a synchronisation between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def operands(gen, b, h, w, ci, co):
    x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
    kern = torch.randn(3, 3, ci, co, generator=gen, device="cuda") * (9 * ci) ** -0.5
    bias = torch.randn(co, generator=gen, device="cuda") * 0.1
    w_cl = kern.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return x, kern, bias, x.permute(0, 3, 1, 2), w_cl, bias.to(torch.bfloat16)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_kernels_events: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"root={ROOT} card={card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, h, w, c in CONV_CASES + FUSED_CONV_CASES:
        x, kern, bias, x_cl, w_cl, bias16 = operands(gen, b, h, w, c, c)
        kern = kern.to(torch.bfloat16)   # as chip_smoke phase 21 holds it
        if label.startswith("fused"):
            gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
            scale, shift = cv.groupnorm_affine_fold(x, gamma, beta)
            res = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)

            def kernel():
                return cv.conv3x3_gemm(x, kern, bias, prologue_scale=scale,
                                       prologue_shift=shift, silu_prologue=True, residual=res)

            def library():
                xa = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
                y = F.conv2d(xa.to(torch.bfloat16).permute(0, 3, 1, 2), w_cl, padding=1)
                return (y.permute(0, 2, 3, 1).float() + bias + res.float()).to(torch.bfloat16)
            name, lib_name = "K7_v2_fused", "unfused_chain"
        else:
            def kernel():
                return cv.conv3x3_pallas(x, kern, bias)

            def library():
                return F.conv2d(x_cl, w_cl, bias16, padding=1)
            name, lib_name = "K7_v1", "cudnn_conv"
        print(f"{name} {label} kernel_ms={cuda_ms(kernel):.4f} "
              f"{lib_name}_ms={cuda_ms(library):.4f} host_us={host_us(kernel):.1f} / "
              f"{host_us(library):.1f} card={card}", flush=True)
        del x, x_cl, w_cl
        torch.cuda.empty_cache()
    for label, b, h, w, ci, co in WINO43_CASES:
        x, kern, bias, x_cl, w_cl, bias16 = operands(gen, b, h, w, ci, co)
        u = w43.transform_weights43(kern).to(torch.bfloat16).contiguous()

        def kernel():
            return w43.conv3x3_winograd43(x, kern, bias, u)

        def library():
            return F.conv2d(x_cl, w_cl, bias16, padding=1)

        print(f"K8 {label} kernel_ms={cuda_ms(kernel):.4f} cudnn_conv_ms={cuda_ms(library):.4f} "
              f"host_us={host_us(kernel):.1f} / {host_us(library):.1f} card={card}", flush=True)
        del x, x_cl, w_cl, u
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
