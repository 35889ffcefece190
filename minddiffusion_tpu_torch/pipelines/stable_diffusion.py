"""Stable Diffusion txt2img, img2img and inpaint (port of
minddiffusion_tpu/pipelines/stable_diffusion.py).

    models = SDModels.create(family="sd2", dtype=torch.bfloat16,
                             attn_impl="fast", device="cuda", generator=g)
    fn = StableDiffusionPipeline(models).build_txt2img(
        height=512, width=512, num_steps=50, sampler="ddim",
        guidance_scale=9.0, batch_size=8)
    images = fn(models, tokens, uncond_tokens, generator)  # uint8 (B, H, W, 3)

One txt2img call: CLIP encode of the CFG-folded [uncond; cond] tokens, the
sampler's step loop over the guided UNet, VAE decode, uint8 quantization.
The two sampling savings of the JAX package are on by default: the UNet
runs its prefix once at batch B (CFG-prefix dedup, `cfg_fold`) in txt2img
and img2img, and every pipeline keeps the cross-attention K/V and the
Winograd transforms for the whole sampler run (`UNetModel.hoisted`). Their
switches, MDT_CFG_DEDUP and MDT_HOIST (utils/flags.py), are read at each
call. inpaint runs the UNet at 2B throughout, as the JAX package does
where a channel concat joins the UNet input. Explicit `noise=` (B, H/8, W/8, 4)
replaces the draw from `generator`. img2img encodes the init image first and
starts DDIM mid-chain; its explicit `enc_noise=` / `noise=` replace the
posterior draw and the q_sample noise. inpaint (the "wukong-inpaint" family's
9-channel UNet) encodes the masked image and feeds [x_t, mask, z_masked] to
the UNet at every step; `enc_noise=` / `noise=` replace its posterior draw
and x_T.

Families: "sd2" (CLIP-H + SD2 UNet), "wukong" (zh CLIP-L with QuickGELU +
SD1 UNet, 8 heads, 1x1-conv proj_in/out), "wukong-inpaint" (the same with
the 9-channel UNet); all share the KL-VAE and the linear schedule.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from minddiffusion_tpu_torch.core import cfg as cfg_lib
from minddiffusion_tpu_torch.core import distributions, latents
from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.io.sd_weights import PREFIXES
from minddiffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from minddiffusion_tpu_torch.models.layers import (
    GroupNorm32, LayerNormFp32, cast_for_inference)
from minddiffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from minddiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from minddiffusion_tpu_torch.parallel.collectives import all_gather_rows
from minddiffusion_tpu_torch.parallel.mesh import Rows, batch_sharding
from minddiffusion_tpu_torch.samplers import ddim, dpm_solver, plms
from minddiffusion_tpu_torch.utils.flags import flags

SAMPLERS = ("ddim", "plms", "dpm", "dpm_singlestep", "dpm_adaptive")
FAMILIES = {  # family: (UNet preset, text encoder preset)
    "sd2": (UNetConfig.sd2, CLIPTextConfig.sd2_en),
    "wukong": (UNetConfig.sd1, CLIPTextConfig.wukong_zh),
    "wukong-inpaint": (UNetConfig.sd1_inpaint, CLIPTextConfig.wukong_zh),
}


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights at the SD scale, none of them zero but the LoRA
    B matrices: linear and conv weights N(0, 1/fan_in), biases N(0, 0.02^2),
    norm scales 1 + N(0, 0.05^2) and shifts N(0, 0.05^2), token embeddings
    N(0, 0.02^2), positional embeddings N(0, 0.01^2), LoRA A N(0, 0.02^2),
    LoRA B zero (the JAX init)."""
    def normal(p, std, mean=0.0):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                    * std + mean)

    norm_params = set()
    for m in module.modules():
        if isinstance(m, (GroupNorm32, LayerNormFp32)):
            normal(m.weight, 0.05, 1.0)
            normal(m.bias, 0.05)
            norm_params |= {id(m.weight), id(m.bias)}
    for name, p in module.named_parameters():
        if id(p) in norm_params:
            continue
        if name.endswith(".lora_b"):      # zero: LoRA starts as a no-op
            with torch.no_grad():
                p.zero_()
        elif name.endswith(".lora_a"):
            normal(p, 0.02)
        elif name.endswith("token_embedding.weight"):
            normal(p, 0.02)
        elif name.endswith("positional_embedding"):
            normal(p, 0.01)
        elif p.ndim >= 2:
            normal(p, float(np.prod(p.shape[1:])) ** -0.5)
        else:
            normal(p, 0.02)


def create_sd_models(**kwargs) -> "SDModels":
    """`SDModels.create` for `instantiate_from_config` YAML targets: a
    `dtype` of "bf16" or "fp32" names the torch dtype. On the card unless
    the params give another `device` ("cpu", "meta")."""
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = {"bf16": torch.bfloat16, "fp32": torch.float32}[kwargs["dtype"]]
    return SDModels.create(**kwargs)


@dataclasses.dataclass
class SDModels:
    """The three SD networks (with their weights) and the noise schedule."""

    unet: UNetModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    schedule: DiffusionSchedule
    scale_factor: float = latents.DEFAULT_SCALE_FACTOR

    @property
    def latent_factor(self) -> int:
        return 2 ** (len(self.vae.config.ch_mult) - 1)

    @property
    def device(self) -> torch.device:
        return self.unet.time_embed[0].weight.device

    def modules(self) -> Dict[str, nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}

    @classmethod
    def create(cls, family: str = "sd2", dtype: torch.dtype = torch.bfloat16,
               attn_impl: Optional[str] = None, device="cuda",
               generator: Optional[torch.Generator] = None,
               unet_config: Optional[UNetConfig] = None,
               vae_config: Optional[VAEConfig] = None,
               text_config: Optional[CLIPTextConfig] = None,
               param_dtype: Optional[torch.dtype] = None,
               enable_lora: bool = False, lora_rank: int = 4, lora_alpha: float = 4.0,
               timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.0120) -> "SDModels":
        """Build on `device`. With `generator` the weights are drawn by
        `init_random_`; without, they are zero until `load_state_dict`.
        `dtype` is the compute dtype; on a CUDA device it is bfloat16, the
        one the kernels take. `param_dtype` None stores the weights in
        `dtype` (norms in fp32, `cast_for_inference`); torch.float32 keeps
        fp32 master weights under `dtype` compute, the training form (the
        JAX package's dtype=bf16, param_dtype=fp32). `enable_lora` puts
        adapters of `lora_rank` and `lora_alpha` on the preset UNet's
        attention projections. The schedule is SD's "linear" one over
        `timesteps` from `linear_start` to `linear_end`."""
        if family not in FAMILIES:
            raise ValueError(f"unknown SD family {family!r}; ported: {list(FAMILIES)}")
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels take bfloat16, got {dtype}; "
                             "use bfloat16 on a CUDA device (fp32 runs on the CPU)")
        unet_preset, text_preset = FAMILIES[family]
        unet_config = unet_config or unet_preset(
            attn_impl=attn_impl, enable_lora=enable_lora, lora_rank=lora_rank,
            lora_alpha=lora_alpha)
        with torch.device("meta"):
            nets = dict(unet=UNetModel(unet_config),
                        vae=AutoencoderKL(vae_config or VAEConfig()),
                        text_encoder=CLIPTextEncoder(text_config or text_preset()))
        for name, net in nets.items():
            net.to_empty(device=device)
            if generator is not None:
                init_random_(net, generator)
            else:
                for p in net.parameters():
                    p.detach().zero_()
            if param_dtype is None:
                nets[name] = cast_for_inference(net, dtype).eval()
            else:
                net.to(param_dtype).compute_dtype = dtype
                nets[name] = net.eval()
        schedule = DiffusionSchedule.create(timesteps, linear_start, linear_end)
        return cls(schedule=schedule, **nets)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The flat LDM-named state dict of the three networks (the names
        `load_state_dict` takes)."""
        return {PREFIXES[kind] + k: v for kind, module in self.modules().items()
                for k, v in module.state_dict().items()}

    def load_state_dict(self, state_dict: Dict[str, np.ndarray]) -> None:
        """Strict load of a flat LDM state dict (io/sd_weights.py names)."""
        used = set()
        for kind, module in self.modules().items():
            prefix = PREFIXES[kind]
            sub = {k[len(prefix):]: torch.as_tensor(np.asarray(v))
                   for k, v in state_dict.items() if k.startswith(prefix)}
            used |= {prefix + k for k in sub}
            module.load_state_dict(sub, strict=True)
        unused = sorted(set(state_dict) - used)
        if unused:
            raise KeyError(f"unused checkpoint keys: {unused[:5]}")


def _run_sampler(sampler: str, eps_fn, x_T: torch.Tensor, schedule: DiffusionSchedule,
                 num_steps: int, generator: Optional[torch.Generator],
                 t_start_index: Optional[int] = None,
                 mask: Optional[torch.Tensor] = None,
                 x0: Optional[torch.Tensor] = None,
                 rows: Rows = Rows()) -> torch.Tensor:
    """`mask` (1 = keep) and `x0` blend the known latent region into every
    step (ddim, plms, dpm, dpm_singlestep; the noise from `generator`).
    `rows`: where `x_T` is this rank's block of a batch split over data
    ranks, the adaptive solver's step control spans the whole batch."""
    if t_start_index is not None and sampler != "ddim":
        # a mid-chain start (img2img strength < 1) exists for DDIM only; the
        # PLMS history and the DPM tables are built for full chains
        raise ValueError(f"t_start_index (img2img strength<1) requires "
                         f"sampler='ddim', got {sampler!r}")
    if sampler == "dpm_adaptive" and (mask is not None or x0 is not None):
        raise ValueError("dpm_adaptive does not support mask/x0 blending")
    blend = dict(mask=mask, x0=x0, generator=generator)
    if sampler == "ddim":
        return ddim.sample(eps_fn, x_T, schedule, num_steps=num_steps,
                           t_start_index=t_start_index, **blend)
    if sampler == "plms":
        return plms.sample(eps_fn, x_T, schedule, num_steps=num_steps, **blend)
    if sampler == "dpm":
        return dpm_solver.sample(eps_fn, x_T, schedule, steps=num_steps, **blend)
    if sampler == "dpm_singlestep":
        return dpm_solver.sample_singlestep(eps_fn, x_T, schedule, steps=num_steps,
                                            **blend)
    if sampler == "dpm_adaptive":
        # the solver controls its own step size; num_steps is not used. On
        # a grid its error norm spans the data ranks (a Rows group of None
        # is the world)
        group = None
        if rows.count > 1:
            import torch.distributed as dist

            group = dist.group.WORLD if rows.group is None else rows.group
        return dpm_solver.sample_adaptive(eps_fn, x_T, schedule, group=group)
    raise ValueError(f"unknown sampler {sampler!r}; ported: {list(SAMPLERS)}")


def _guided_unet(unet: UNetModel, ctx2: torch.Tensor, guidance_scale: float) -> Callable:
    """The CFG-guided eps model of `unet`; under MDT_CFG_DEDUP (on by
    default) the UNet's prefix runs once at batch B (`cfg_fold`)."""
    if flags().cfg_dedup:
        return cfg_lib.wrap_model(functools.partial(unet, cfg_fold=True), ctx2,
                                  guidance_scale, dedup=True)
    return cfg_lib.wrap_model(unet, ctx2, guidance_scale)


def _explicit(name: str, value, shape: tuple, device) -> torch.Tensor:
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(value.shape)}")
    return torch.as_tensor(value).float().to(device)


class StableDiffusionPipeline:
    def __init__(self, models: SDModels):
        self.models = models

    def build_txt2img(self, height: int = 512, width: int = 512,
                      num_steps: int = 50, sampler: str = "plms",
                      guidance_scale: float = 9.0, batch_size: int = 1,
                      mesh=None) -> Callable:
        """fn(models, tokens, uncond_tokens, generator, noise=None) -> uint8
        images (B, H, W, 3); tokens (B, L) ints. `fn.latents` (same call)
        returns the final latent instead.

        `mesh` (parallel/mesh.make_mesh; JAX's `mesh=`): one request batch
        split over the data ranks (dp x fsdp; batch_size must divide over
        them), every rank with the whole weights (also on a grid with tp >
        1, as in JAX: no tp compute in inference; each tp rank of a data
        rank samples the same rows). Each rank is called with the whole
        batch, draws the whole x_T from `generator` and keeps its rows,
        samples and decodes them (`dpm_adaptive` takes its error norm over
        the data ranks, so it steps as on the whole batch), and every rank
        returns the whole batch gathered back over its data ranks: the
        bytes of the one-process call on the CPU; on the card those of one
        process that runs the networks a row block at a time, since there
        a row's result depends on its place in a batch. (The JAX
        mesh variant switches to the interleaved CFG layout, a TPU-only
        rewrite not ported.)"""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; ported: {list(SAMPLERS)}")
        f = self.models.latent_factor
        h8, w8 = height // f, width // f
        shape = (batch_size, h8, w8, 4)
        rows = batch_sharding(mesh)
        if batch_size % rows.count:
            raise ValueError(f"batch_size {batch_size} does not divide over the mesh's "
                             f"{rows.count} data ranks")

        @torch.inference_mode()
        def sample_latents(models: SDModels, tokens, uncond_tokens,
                           generator: Optional[torch.Generator],
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            dev = models.device
            tokens, uncond_tokens = (rows.take(torch.as_tensor(t), "tokens")
                                     for t in (tokens, uncond_tokens))
            tok2 = cfg_lib.fold(uncond_tokens, tokens)
            ctx2 = models.text_encoder(tok2.to(dev))
            eps_fn = _guided_unet(models.unet, ctx2, guidance_scale)
            x_T = rows.take(torch.randn(shape, generator=generator, device=dev)
                            if noise is None else _explicit("noise", noise, shape, dev))
            with models.unet.hoisted():
                return _run_sampler(sampler, eps_fn, x_T, models.schedule,
                                    num_steps, generator, rows=rows)

        @torch.inference_mode()
        def fn(models: SDModels, tokens, uncond_tokens,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            z = sample_latents(models, tokens, uncond_tokens, generator, noise)
            img = models.vae.decode(latents.unscale_latents(z, models.scale_factor))
            return all_gather_rows(latents.unit_range_to_uint8(img), rows)

        fn.latents = lambda *a, **kw: all_gather_rows(sample_latents(*a, **kw), rows)
        return fn

    def build_img2img(self, height: int = 512, width: int = 512,
                      num_steps: int = 50, strength: float = 0.75,
                      guidance_scale: float = 9.0) -> Callable:
        """fn(models, init_image, tokens, uncond_tokens, generator,
        enc_noise=None, noise=None) -> uint8 images (B, H, W, 3).

        init_image (B, H, W, 3) in [-1, 1]. Encodes it, draws z0 from the
        posterior (`enc_noise` (B, H/8, W/8, 4) replaces the draw), q_samples
        z0 to DDIM step floor(strength * num_steps) from the end (`noise`
        replaces that draw), denoises from there with DDIM (the one sampler
        with a mid-chain start), decodes. `fn.latents` (same call) returns
        the final latent instead."""
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        t_enc = int(strength * num_steps)
        if t_enc < 1:
            raise ValueError(
                f"strength={strength} rounds to 0 denoise steps at "
                f"num_steps={num_steps} — raise strength or num_steps")
        tables = ddim.build_tables(self.models.schedule, num_steps)
        t_at = int(tables["t"][num_steps - t_enc])
        f = self.models.latent_factor
        h8, w8 = height // f, width // f

        @torch.inference_mode()
        def sample_latents(models: SDModels, init_image, tokens, uncond_tokens,
                           generator: Optional[torch.Generator],
                           enc_noise: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            dev = models.device
            init_image = torch.as_tensor(init_image)
            b = init_image.shape[0]
            if tuple(init_image.shape) != (b, height, width, 3):
                raise ValueError(f"init_image must be (B, {height}, {width}, 3), "
                                 f"got {tuple(init_image.shape)}")
            shape = (b, h8, w8, 4)
            tok2 = cfg_lib.fold(torch.as_tensor(uncond_tokens), torch.as_tensor(tokens))
            ctx2 = models.text_encoder(tok2.to(dev))
            eps_fn = _guided_unet(models.unet, ctx2, guidance_scale)
            moments = models.vae.encode(init_image.to(dev))
            eps = None if enc_noise is None else _explicit("enc_noise", enc_noise, shape, dev)
            z0 = latents.scale_latents(distributions.sample(moments, generator, eps),
                                       models.scale_factor)
            noise = (torch.randn(shape, generator=generator, device=dev) if noise is None
                     else _explicit("noise", noise, shape, dev))
            x_mid = models.schedule.q_sample(z0, torch.full((b,), t_at), noise)
            with models.unet.hoisted():
                return _run_sampler("ddim", eps_fn, x_mid, models.schedule,
                                    num_steps, generator, t_start_index=t_enc)

        @torch.inference_mode()
        def fn(models: SDModels, init_image, tokens, uncond_tokens,
               generator: Optional[torch.Generator],
               enc_noise: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            z = sample_latents(models, init_image, tokens, uncond_tokens, generator,
                               enc_noise, noise)
            img = models.vae.decode(latents.unscale_latents(z, models.scale_factor))
            return latents.unit_range_to_uint8(img)

        fn.latents = sample_latents
        return fn

    def build_inpaint(self, height: int = 512, width: int = 512,
                      num_steps: int = 50, sampler: str = "plms",
                      guidance_scale: float = 7.5) -> Callable:
        """fn(models, image, mask, tokens, uncond_tokens, generator,
        enc_noise=None, noise=None) -> uint8 images (B, H, W, 3).

        image (B, H, W, 3) in [-1, 1]; mask (B, H, W, 1), 1 = the region to
        repaint, binarised at >= 0.5. The masked image image * (1 - mask)
        is encoded and its posterior sampled (`enc_noise` (B, H/8, W/8, 4)
        replaces the draw); the mask goes to the latent grid by half-pixel
        nearest resampling (latent pixel i reads image pixel 8i + 4, JAX's
        `jax.image.resize(..., "nearest")`, torch's "nearest-exact"). Every
        UNet eval takes [x_t, mask, z_masked] (9 channels), the same for the
        cond and uncond halves. x_T is drawn from `generator` (`noise`
        replaces it). `fn.latents` (same call) returns the final latent."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; ported: {list(SAMPLERS)}")
        if self.models.unet.config.in_channels != 9:
            raise ValueError("inpaint needs the 9-channel UNet (family 'wukong-inpaint')")
        f = self.models.latent_factor
        h8, w8 = height // f, width // f

        @torch.inference_mode()
        def sample_latents(models: SDModels, image, mask, tokens, uncond_tokens,
                           generator: Optional[torch.Generator],
                           enc_noise: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            dev = models.device
            image, mask = torch.as_tensor(image).to(dev), torch.as_tensor(mask).to(dev)
            b = image.shape[0]
            if tuple(image.shape) != (b, height, width, 3) or \
                    tuple(mask.shape) != (b, height, width, 1):
                raise ValueError(f"image must be (B, {height}, {width}, 3) and mask "
                                 f"(B, {height}, {width}, 1), got {tuple(image.shape)}, "
                                 f"{tuple(mask.shape)}")
            shape = (b, h8, w8, 4)
            mask = (mask.float() >= 0.5).float()
            masked_image = image.float() * (1.0 - mask)
            tok2 = cfg_lib.fold(torch.as_tensor(uncond_tokens), torch.as_tensor(tokens))
            ctx2 = models.text_encoder(tok2.to(dev))
            moments = models.vae.encode(masked_image)
            eps = None if enc_noise is None else _explicit("enc_noise", enc_noise, shape, dev)
            z_masked = latents.scale_latents(distributions.sample(moments, generator, eps),
                                             models.scale_factor)
            mask_lat = torch.nn.functional.interpolate(
                mask.permute(0, 3, 1, 2), size=(h8, w8),
                mode="nearest-exact").permute(0, 2, 3, 1)
            c_cat2 = cfg_lib.duplicate(torch.cat([mask_lat, z_masked], dim=-1))

            def unet_9ch(x2, t2, ctx):
                return models.unet(torch.cat([x2, c_cat2.to(x2.dtype)], dim=-1), t2, ctx)

            eps_fn = cfg_lib.wrap_model(unet_9ch, ctx2, guidance_scale)
            x_T = (torch.randn(shape, generator=generator, device=dev) if noise is None
                   else _explicit("noise", noise, shape, dev))
            with models.unet.hoisted():
                return _run_sampler(sampler, eps_fn, x_T, models.schedule, num_steps,
                                    generator)

        @torch.inference_mode()
        def fn(models: SDModels, image, mask, tokens, uncond_tokens,
               generator: Optional[torch.Generator],
               enc_noise: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            z = sample_latents(models, image, mask, tokens, uncond_tokens, generator,
                               enc_noise, noise)
            img = models.vae.decode(latents.unscale_latents(z, models.scale_factor))
            return latents.unit_range_to_uint8(img)

        fn.latents = sample_latents
        return fn
