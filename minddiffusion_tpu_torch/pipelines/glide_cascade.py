"""Taichu-GLIDE cascade: 64 px guided base -> 256 px DDIM super-res -> 1024 px
SRGAN (port of minddiffusion_tpu/pipelines/glide_cascade.py).

    models = GlideModels.create(dtype=torch.bfloat16, device="cuda", generator=g)
    fn = GlideCascadePipeline(models).build_generate(batch_size=8)
    out = fn(models, tokens, mask, generator)   # {"base", "super_res", "srgan"}: uint8 NHWC

  * base: ancestral sampling over the respaced ("60") squaredcos_cap_v2
    schedule with classifier-free guidance in [cond; uncond] order, the
    uncond half on random tokens in [1, n_vocab - 1) with an all-ones mask,
    eps = uncond + s (cond - uncond) and the variance of the cond half.
    uncond_mode "per_generation" draws the uncond tokens once and runs the
    xf once; "per_step" draws one uncond token row per step (broadcast over
    the batch) and encodes it inside the step, as the reference does.
  * super-res: DDIM (eta 0) over the respaced ("fast27") linear_plain
    schedule, x_T scaled by upsample_temp, the low-res input quantized
    through a uint8 round-trip, no guidance.
  * SRGAN x4 on clip(img256, -1, 1) in fp32.

Every random draw comes from `generator` unless given explicitly:
`uncond_tokens` (B, ctx), `noise` (base x_T), `step_noise` (one base-shaped
tensor per base step), `uncond_rows` (per_step mode: one (ctx,) row per
step), `sr_noise` (the SR x_T before the upsample_temp scale). `row_seeds`
(B,) ints (per_generation mode) fixes them all per row instead: row b's
uncond tokens (tag 1), base x_T (2), ancestral noise of every step (3) and
super-res x_T (4) come from a generator of their own on the models' device,
seeded with seed_b * 8 + tag (`row_seed_draws`), so row b's images depend on
seed_b alone, whatever the other rows hold (the serving engine's
per-request determinism). The draws are not the JAX package's bits (the
RNGs differ); the tags are its `fold_in` tags.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from minddiffusion_tpu_torch.core.latents import unit_range_to_uint8
from minddiffusion_tpu_torch.core.schedules import (
    DiffusionSchedule, make_beta_schedule, respace_schedule, space_timesteps)
from minddiffusion_tpu_torch.models.glide import (
    GlideUNetConfig, SuperResText2ImUNet, Text2ImUNet, XfConfig)
from minddiffusion_tpu_torch.models.layers import cast_for_inference
from minddiffusion_tpu_torch.models.srgan import BatchNorm, PReLU, SRGANGenerator
from minddiffusion_tpu_torch.pipelines.stable_diffusion import init_random_
from minddiffusion_tpu_torch.samplers import ancestral

UNCOND_MODES = ("per_generation", "per_step")


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The super-res conditioning through a uint8 round-trip (no clip)."""
    return torch.round((x + 1.0) * 127.5) / 127.5 - 1.0


def init_random_glide_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, none of them zero: `init_random_`'s SD scales,
    then token embeddings N(0, 0.02^2), padding embeddings N(0, 0.01^2),
    BatchNorm scale 1 + N(0, 0.05^2), bias and mean N(0, 0.05^2), var
    1 + 0.1 |N(0, 1)|, PReLU slopes 0.25 + N(0, 0.02^2)."""
    init_random_(module, generator)

    def draw(t, std, mean=0.0):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std + mean)

    for name, p in module.named_parameters():
        if name.endswith("token_embedding"):
            draw(p, 0.02)
        elif name.endswith("padding_embedding"):
            draw(p, 0.01)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            draw(m.scale, 0.05, 1.0)
            draw(m.bias, 0.05)
            draw(m.mean, 0.05)
            draw(m.var, 0.1)
            m.var.abs_().add_(1.0)
        elif isinstance(m, PReLU):
            draw(m.alpha, 0.02, 0.25)


def create_glide_models(**kwargs) -> "GlideModels":
    """`GlideModels.create` for `instantiate_from_config` YAML targets: a
    `dtype` of "bf16" or "fp32" names the torch dtype. On the card unless
    the params give another `device`."""
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = {"bf16": torch.bfloat16, "fp32": torch.float32}[kwargs["dtype"]]
    return GlideModels.create(**kwargs)


@dataclasses.dataclass
class GlideModels:
    """The three networks of the cascade (with their weights) and the two
    respaced schedules."""

    base: Text2ImUNet
    super_res: SuperResText2ImUNet
    srgan: Optional[SRGANGenerator]
    base_schedule: DiffusionSchedule    # respaced (e.g. "60") squaredcos_cap_v2
    sr_schedule: DiffusionSchedule      # respaced "fast27" linear_plain

    @property
    def device(self) -> torch.device:
        return self.base.device

    def modules(self) -> Dict[str, nn.Module]:
        nets = {"base": self.base, "super_res": self.super_res}
        if self.srgan is not None:
            nets["srgan"] = self.srgan
        return nets

    @classmethod
    def create(cls, dtype: torch.dtype = torch.bfloat16, base_respacing: str = "60",
               sr_respacing: str = "fast27", diffusion_steps: int = 1000,
               with_srgan: bool = True, base_unet: Optional[GlideUNetConfig] = None,
               sr_unet: Optional[GlideUNetConfig] = None, xf: Optional[XfConfig] = None,
               attn_impl: Optional[str] = None, device="cuda",
               generator: Optional[torch.Generator] = None) -> "GlideModels":
        """Defaults: `GlideUNetConfig.base_64`, `upsample_256`, `XfConfig()`
        (`debug_tokens` from MDT_DEBUG_TOKENS). With `generator` the weights
        are drawn by `init_random_glide_`; without, they are zero until
        `load_state_dict`. The UNets and the xf run in `dtype` (bfloat16 on
        a CUDA device, the one the kernels take); the SRGAN runs in fp32."""
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels take bfloat16, got {dtype}; "
                             "use bfloat16 on a CUDA device (fp32 runs on the CPU)")
        base_unet = base_unet or GlideUNetConfig.base_64(attn_impl=attn_impl)
        sr_unet = sr_unet or GlideUNetConfig.upsample_256(attn_impl=attn_impl)
        xf = xf or XfConfig(debug_tokens=bool(os.environ.get("MDT_DEBUG_TOKENS")))
        with torch.device("meta"):
            nets = dict(base=Text2ImUNet(base_unet, xf),
                        super_res=SuperResText2ImUNet(sr_unet, xf))
            if with_srgan:
                nets["srgan"] = SRGANGenerator(upscale_factor=4)
        for name, net in nets.items():
            net.to_empty(device=device)
            if generator is not None:
                init_random_glide_(net, generator)
            else:
                with torch.no_grad():
                    for t in (*net.parameters(), *net.buffers()):
                        t.zero_()
            net = net.float() if name == "srgan" else cast_for_inference(net, dtype)
            nets[name] = net.eval()
        base_betas = make_beta_schedule(diffusion_steps, schedule="squaredcos_cap_v2")
        sr_betas = make_beta_schedule(diffusion_steps, schedule="linear_plain")
        return cls(
            srgan=nets.pop("srgan", None), **nets,
            base_schedule=respace_schedule(
                base_betas, space_timesteps(diffusion_steps, base_respacing)),
            sr_schedule=respace_schedule(
                sr_betas, space_timesteps(diffusion_steps, sr_respacing)))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every stage's state dict in one, the stage as prefix."""
        return {f"{stage}.{k}": v for stage, module in self.modules().items()
                for k, v in module.state_dict().items()}

    def load_state_dict(self, state_dict: Dict[str, np.ndarray]) -> None:
        """Strict load of a flat state dict (numpy arrays or tensors) whose
        keys carry the stage as prefix ("base.", "super_res.", "srgan.";
        io/glide_weights.py)."""
        used = set()
        for stage, module in self.modules().items():
            prefix = stage + "."
            sub = {k[len(prefix):]: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                   for k, v in state_dict.items() if k.startswith(prefix)}
            used |= {prefix + k for k in sub}
            module.load_state_dict(sub, strict=True)
        unused = sorted(set(state_dict) - used)
        if unused:
            raise KeyError(f"unused checkpoint keys: {unused[:5]}")


ROW_SEED_TAGS = 8   # a row's generators are seeded seed * 8 + tag, tags 1-4


def row_seed_draws(models: GlideModels, row_seeds, base_size: int = 64,
                   sr_size: int = 256) -> Dict[str, torch.Tensor]:
    """The explicit draws `row_seeds` stands for: {"uncond_tokens" (B, ctx)
    in [1, n_vocab - 1), "noise" (B, base, base, 3), "step_noise" (steps, B,
    base, base, 3), "sr_noise" (B, sr, sr, 3)}, each row from its own
    generators (module docstring). Seeds are in [0, 2**31)."""
    seeds = [int(s) for s in np.asarray(row_seeds).reshape(-1)]
    if any(not 0 <= s < 2**31 for s in seeds):
        raise ValueError(f"row_seeds must be in [0, 2**31), got {seeds}")
    dev = models.device
    xf = models.base.xf_config
    steps = models.base_schedule.num_timesteps

    def gen(seed: int, tag: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed * ROW_SEED_TAGS + tag)

    def normal(tag: int, shape: tuple) -> torch.Tensor:
        return torch.stack([torch.randn(shape, generator=gen(s, tag), device=dev)
                            for s in seeds])

    return {
        "uncond_tokens": torch.stack([
            torch.randint(1, xf.n_vocab - 1, (xf.text_ctx,), generator=gen(s, 1), device=dev)
            for s in seeds]),
        "noise": normal(2, (base_size, base_size, 3)),
        "step_noise": normal(3, (steps, base_size, base_size, 3)).transpose(0, 1),
        "sr_noise": normal(4, (sr_size, sr_size, 3)),
    }


def _explicit(name: str, value, shape: tuple, device, dtype=torch.float32) -> torch.Tensor:
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(value.shape)}")
    return value.to(device, dtype)


class GlideCascadePipeline:
    def __init__(self, models: GlideModels):
        self.models = models

    def build_generate(self, batch_size: int = 1, guidance_scale: float = 5.0,
                       base_size: int = 64, sr_size: int = 256,
                       upsample_temp: float = 0.997, run_srgan: bool = True,
                       uncond_mode: str = "per_generation") -> Callable:
        """fn(models, tokens, mask, generator, *, uncond_tokens=None,
        noise=None, step_noise=None, uncond_rows=None, sr_noise=None,
        timings=None, row_seeds=None) -> {"base": (B, base, base, 3),
        "super_res": (B, sr, sr, 3)[, "srgan": (B, 4 sr, 4 sr, 3)]} uint8.

        tokens / mask (B, text_ctx) ints. `timings`, a dict, receives the
        seconds of each stage (the device synchronised at each boundary).
        `fn.base_stage(models, tokens, mask, generator, uncond_tokens, noise,
        step_noise, uncond_rows)` and `fn.sr_stage(models, img64, tokens,
        mask, generator, sr_noise)` return the fp32 images of the two
        diffusion stages (tokens and mask as (B, text_ctx) int64 tensors on
        the models' device)."""
        if uncond_mode not in UNCOND_MODES:
            raise ValueError(f"uncond_mode {uncond_mode!r}; expected one of {UNCOND_MODES}")
        xf_cfg = self.models.base.xf_config
        vocab, ctx, b = xf_cfg.n_vocab, xf_cfg.text_ctx, batch_size

        @torch.inference_mode()
        def base_stage(models: GlideModels, tokens, mask, generator, uncond_tokens,
                       noise, step_noise, uncond_rows) -> torch.Tensor:
            dev, base = models.device, models.base
            n_steps = models.base_schedule.num_timesteps

            def draw_tokens(shape):
                return torch.randint(1, vocab - 1, shape, generator=generator, device=dev)

            def cfg_denoise(x, t, xf_proj2, xf_out2):
                eps2, v2 = base.denoise(torch.cat([x, x]), t, xf_proj2, xf_out2)
                eps_c, eps_u = eps2.chunk(2)
                return eps_u + guidance_scale * (eps_c - eps_u), v2[:b]

            unc_mask = torch.ones_like(mask)
            step_args = None
            if uncond_mode == "per_generation":
                unc = (draw_tokens((b, ctx)) if uncond_tokens is None else
                       _explicit("uncond_tokens", uncond_tokens, (b, ctx), dev, torch.int64))
                xf_proj2, xf_out2 = base.encode_text(torch.cat([tokens, unc]),
                                                     torch.cat([mask, unc_mask]))

                def model_fn(x, t):
                    return cfg_denoise(x, t, xf_proj2, xf_out2)
            else:
                xf_proj_c, xf_out_c = base.encode_text(tokens, mask)
                step_args = ([draw_tokens((ctx,)) for _ in range(n_steps)]
                             if uncond_rows is None else
                             _explicit("uncond_rows", uncond_rows, (n_steps, ctx), dev,
                                       torch.int64))

                def model_fn(x, t, unc_row):
                    xf_proj_u, xf_out_u = base.encode_text(unc_row.expand(b, ctx), unc_mask)
                    return cfg_denoise(x, t, torch.cat([xf_proj_c, xf_proj_u]),
                                       torch.cat([xf_out_c, xf_out_u]))

            shape = (b, base_size, base_size, 3)
            x_T = (torch.randn(shape, generator=generator, device=dev) if noise is None
                   else _explicit("noise", noise, shape, dev))
            if step_noise is not None:
                step_noise = _explicit("step_noise", step_noise, (n_steps, *shape), dev)
            # per_step re-encodes the uncond half every step: no K/V to keep
            with base.hoisted(kv=uncond_mode == "per_generation"):
                return ancestral.p_sample_loop(model_fn, x_T, models.base_schedule,
                                               generator, noise=step_noise,
                                               step_args=step_args)

        @torch.inference_mode()
        def sr_stage(models: GlideModels, img64, tokens, mask, generator,
                     sr_noise) -> torch.Tensor:
            dev, sr = models.device, models.super_res
            low_res = quantize_roundtrip(img64)
            xf_proj, xf_out = sr.encode_text(tokens, mask)
            shape = (b, sr_size, sr_size, 3)
            x_T = upsample_temp * (
                torch.randn(shape, generator=generator, device=dev) if sr_noise is None
                else _explicit("sr_noise", sr_noise, shape, dev))

            def model_fn(x, t):
                return sr.denoise(x, t, low_res, xf_proj, xf_out)

            with sr.hoisted():
                return ancestral.ddim_sample_loop(model_fn, x_T, models.sr_schedule)

        @torch.inference_mode()
        def fn(models: GlideModels, tokens, mask, generator: Optional[torch.Generator],
               uncond_tokens=None, noise=None, step_noise=None, uncond_rows=None,
               sr_noise=None, timings: Optional[dict] = None,
               row_seeds=None) -> Dict[str, torch.Tensor]:
            dev = models.device
            if row_seeds is not None:
                if uncond_mode != "per_generation":
                    raise ValueError("row_seeds requires uncond_mode='per_generation' (the "
                                     "per_step mode draws batch-level uncond tokens)")
                given = [k for k, v in dict(uncond_tokens=uncond_tokens, noise=noise,
                                            step_noise=step_noise, sr_noise=sr_noise).items()
                         if v is not None]
                if given:
                    raise ValueError(f"row_seeds fixes every draw; {given} given as well")
                if len(row_seeds) != b:
                    raise ValueError(f"row_seeds must hold {b} seeds, got {len(row_seeds)}")
                draws = row_seed_draws(models, row_seeds, base_size, sr_size)
                uncond_tokens, noise, step_noise, sr_noise = (
                    draws[k] for k in ("uncond_tokens", "noise", "step_noise", "sr_noise"))
            tokens = _explicit("tokens", tokens, (b, ctx), dev, torch.int64)
            mask = _explicit("mask", mask, (b, ctx), dev, torch.int64)
            clock = [time.time()]

            def lap(stage):
                if timings is not None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    clock.append(time.time())
                    timings[stage] = clock[-1] - clock[-2]

            img64 = base_stage(models, tokens, mask, generator, uncond_tokens, noise,
                               step_noise, uncond_rows)
            lap("base")
            img256 = sr_stage(models, img64, tokens, mask, generator, sr_noise)
            lap("super_res")
            out = {"base": unit_range_to_uint8(img64), "super_res": unit_range_to_uint8(img256)}
            if run_srgan and models.srgan is not None:
                out["srgan"] = unit_range_to_uint8(models.srgan(img256.clamp(-1.0, 1.0)))
                lap("srgan")
            return out

        fn.base_stage, fn.sr_stage = base_stage, sr_stage
        return fn
