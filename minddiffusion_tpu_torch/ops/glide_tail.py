"""The fused sampler tail (K9): GroupNorm affine + SiLU -> 3x3 conv to the eps
channels -> one DDIM (eta 0) step, and its plain version.

Port of benchmarks/research/glide_tail.py `_tail_call` (`ddim_tail_step`,
`sd_cfg_tail_step`); CUDA source csrc/glide_tail.cu. The JAX package
retired its pipeline hook, so no sampling loop of either package calls it:
`chip_smoke.py` holds it on the card against the port's own GLIDE
super-res step, whose inputs `sr_tail_probe` catches.

  * `tail_step(..., mode="glide")`: h (B, H, W, C) bf16 pre-`out_norm`
    features, x (B, H, W, co) fp32, mult / add (B, C) fp32 GN affine,
    w_eps (3, 3, C, co), b_eps (co,), coefs (4,) = [sr, srm1,
    sqrt(abar_prev), sqrt(max(1 - abar_prev, 0))] -> x_{t-1} (B, H, W, co)
    fp32: pred_x0 from eps, clipped, eps re-derived, the DDIM combination.
  * `tail_step(..., mode="sd")`: h the CFG-folded (2B, ...) [uncond;
    cond] features, x (B, H, W, co); coefs = [scale, cA, cB, 0] ->
    cA x + cB (u + scale (c - u)).

Numerics (`ddim_tail_step_ref`): the affine and SiLU in fp32, rounded to
h's dtype for the conv, the weights rounded to h's dtype, fp32
accumulation plus the fp32 bias; the SAME padding is zero after the
affine. The wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel on the plan `tail_plan` gives (persistent
CTAs over 32 x 8-pixel output tiles, the affine and SiLU in place on each
TMA-landed halo box, the products on wgmma) or raises.
The kernel rounds w_eps (fp32, bf16 or fp16) to bf16 itself, so a call
launches nothing else.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.ops import _build
from minddiffusion_tpu_torch.samplers import ancestral

_SIGNATURES = {   # 8 pointers, bh, H, W, C, co, mode, the two weight types, the plan (5)
    "mdt_glide_tail": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
}
MODES = {"glide": 0, "sd": 1}
KERNEL_CO = (3, 4)          # the GLIDE eps half, the SD latent
SMEM_MAX = 232448           # a block's shared memory on the H100
SMS = 132                   # the H100's SMs, where no card is asked
# csrc/glide_tail.cu's compile-time choices; its C entry refuses a plan that
# states other ones
TILE_W, TILE_H, MIN_STAGES, MAX_STAGES = 32, 8, 2, 4
BOX_PIX = (TILE_W + 2) * (TILE_H + 2)           # the halo box: the products' N
STAGE_BYTES = -(-BOX_PIX * 128 // 1024) * 1024  # a box of 64 channels
W_ROWS = {3: 32, 4: 40}     # W^T's rows a chunk: the 9 co tap-channel rows, padded
Z_STRIDE = BOX_PIX + 4      # Z^T's row stride in floats
WEIGHT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class TailPlan(NamedTuple):
    """How csrc/glide_tail.cu computes one call. tile: output pixels a tile
    (w, h), whose (w + 2) x (h + 2) halo box is the products' N; rows: W^T's
    rows a 64-channel chunk (the 9 co tap-channel rows, padded); chunks:
    64-channel boxes a tile loads (both CFG halves in "sd"); stages: the
    ring's, as many as shared memory holds up to 4; ctas: persistent, one
    an SM; tiles; waves: tiles a CTA; smem: shared-memory bytes a CTA; halo:
    the box's pixels over the output pixels at this shape."""
    tile: tuple
    rows: int
    chunks: int
    stages: int
    ctas: int
    tiles: int
    waves: float
    smem: int
    halo: float


@functools.lru_cache(maxsize=256)
def tail_plan(shape, co: int, mode: str = "glide", sms: int = SMS) -> TailPlan:
    """The plan of csrc/glide_tail.cu for h of shape (bh, H, W, C) to `co`
    eps channels in `mode` on `sms` SMs. Raises ValueError for what the
    kernel does not take: C % 8, co not in KERNEL_CO, an odd "sd" batch,
    or more shared memory than a block has (C above 1600 at co 3, 1152 at
    co 4)."""
    bh, hh, ww, c = (int(v) for v in shape)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {list(MODES)}")
    if (c % 8 or c < 8 or co not in KERNEL_CO or (mode == "sd" and bh % 2)
            or min(bh, hh, ww) < 1):
        raise ValueError(f"kernel takes C % 8 == 0, co in {KERNEL_CO} and an even sd batch; "
                         f"got h {tuple(shape)}, co {co}, mode {mode}")
    halves = 2 if mode == "sd" else 1
    q = -(-c // 64)
    fixed = 1024 + q * W_ROWS[co] * 128 + 9 * co * Z_STRIDE * 4
    stages = max([st for st in range(MIN_STAGES, MAX_STAGES + 1)
                  if fixed + st * (STAGE_BYTES + 16) <= SMEM_MAX], default=MIN_STAGES)
    smem = fixed + stages * (STAGE_BYTES + 16)
    if smem > SMEM_MAX:
        raise ValueError(f"kernel takes C up to what {SMEM_MAX} bytes of shared memory hold; "
                         f"C {c} at co {co} needs {smem}")
    tiles = -(-ww // TILE_W) * -(-hh // TILE_H) * (bh // halves)
    ctas = min(tiles, sms)
    return TailPlan((TILE_W, TILE_H), W_ROWS[co], halves * q, stages, ctas, tiles,
                    tiles / ctas, smem, tiles // (bh // halves) * BOX_PIX / (hh * ww))


def tail_eps(h: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
             w_eps: torch.Tensor, b_eps: torch.Tensor) -> torch.Tensor:
    """eps = conv3x3(silu(h * mult + add) in h's dtype, w_eps in h's dtype)
    + b_eps, accumulated and returned in fp32. (B, H, W, co)."""
    y = h.float() * mult[:, None, None, :].float() + add[:, None, None, :].float()
    xn = (y * torch.sigmoid(y)).to(h.dtype).float()
    w = w_eps.to(h.dtype).float().permute(3, 2, 0, 1)
    eps = F.conv2d(xn.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return eps + b_eps.float()


def ddim_tail_step_plain(h, x, mult, add, w_eps, b_eps, coefs) -> torch.Tensor:
    """K9's "glide" mode in torch ops (see the module docstring)."""
    eps = tail_eps(h, mult, add, w_eps, b_eps)
    sr, srm1, sap, s1map = coefs.float().to(x.device)
    xs = sr * x.float()
    px0 = torch.clamp(xs - srm1 * eps, -1.0, 1.0)
    return sap * px0 + s1map * ((xs - px0) / srm1)


def sd_cfg_tail_step_plain(h, x, mult, add, w_eps, b_eps, coefs) -> torch.Tensor:
    """K9's "sd" mode in torch ops (see the module docstring)."""
    eps = tail_eps(h, mult, add, w_eps, b_eps)
    scale, c_x, c_eps = coefs.float().to(x.device)[:3]
    u, c = eps.chunk(2)
    return c_x * x.float() + c_eps * (u + scale * (c - u))


PLAIN = {"glide": ddim_tail_step_plain, "sd": sd_cfg_tail_step_plain}


def tail_step(h, x, mult, add, w_eps, b_eps, coefs, mode: str = "glide") -> torch.Tensor:
    """K9 in `mode` ("glide" or "sd"). On the card, one launch of
    `tail_plan(h.shape, co, mode)`; counts its launches in
    `tail_step.launches`."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {list(MODES)}")
    if h.device.type == "cpu":
        return PLAIN[mode](h, x, mult, add, w_eps, b_eps, coefs)
    bh, hh, ww, c = h.shape
    co = w_eps.shape[-1]
    bx = bh // 2 if mode == "sd" else bh
    checks = [("h", h, torch.bfloat16, (bh, hh, ww, c)),
              ("x", x, torch.float32, (bx, hh, ww, co)),
              ("mult", mult, torch.float32, (bh, c)), ("add", add, torch.float32, (bh, c)),
              ("w_eps", w_eps, w_eps.dtype, (3, 3, c, co)), ("b_eps", b_eps, b_eps.dtype, (co,)),
              ("coefs", coefs, torch.float32, (4,))]
    for name, t, dt, shape in checks:
        if t.device != h.device:
            raise ValueError(f"{name} must be on {h.device}, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(t.shape)}")
    if h.device.type != "cuda":
        raise ValueError(f"kernel takes CUDA tensors, got {h.device}")
    for name, t in (("w_eps", w_eps), ("b_eps", b_eps)):
        if t.dtype not in WEIGHT_TYPES:
            raise TypeError(f"{name} must be one of {list(WEIGHT_TYPES)}, got {t.dtype}")
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    return _launch(tail_plan(h.shape, co, mode, sms), h, x, mult, add, w_eps, b_eps, coefs,
                   mode)


def _launch(plan: TailPlan, h, x, mult, add, w_eps, b_eps, coefs, mode: str) -> torch.Tensor:
    """Runs `plan` on the card on inputs checked by the caller."""
    bh, hh, ww, c = h.shape
    co = w_eps.shape[-1]
    out = torch.empty((bh // 2 if mode == "sd" else bh, hh, ww, co), dtype=torch.float32,
                      device=h.device)
    lib = _build.load("glide_tail", _SIGNATURES)
    with _build.on_device(h.device):
        err = lib.mdt_glide_tail(h.data_ptr(), x.data_ptr(), mult.data_ptr(), add.data_ptr(),
                                 w_eps.data_ptr(), b_eps.data_ptr(), coefs.data_ptr(),
                                 out.data_ptr(), bh, hh, ww, c, co, MODES[mode],
                                 WEIGHT_TYPES[w_eps.dtype], WEIGHT_TYPES[b_eps.dtype],
                                 *plan.tile, plan.stages, plan.ctas, plan.smem,
                                 torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "glide_tail launch")
    tail_step.launches += 1
    return out


tail_step.launches = 0


@contextlib.contextmanager
def sr_tail_probe(unet: torch.nn.Module, schedule: DiffusionSchedule, step: int):
    """Catch, during one DDIM sampling run of the GLIDE super-res `unet`
    (a `GlideUNet`) over `schedule`, what K9's "glide" mode needs at sampler
    step `step` (0 = the first; not the last). Yields a dict that after the
    run holds, from that step's UNet eval: "h" (the input of the UNet's
    out_norm, caught by a forward pre-hook), "mult" / "add" (out_norm's GN
    affine of it), "w_eps" / "b_eps" (the eps half of out_conv, HWIO),
    "coefs" (the step's DDIM coefficients, fp32 on the device), "x" (x_t)
    and "x_prev" (the port's own unfused step: the x the next eval
    receives)."""
    if not 0 <= step < schedule.num_timesteps - 1:
        raise ValueError(f"step must be in [0, {schedule.num_timesteps - 1}), got {step}")
    calls, got = [0], {}

    def pre_unet(module, args):
        if calls[0] in (step, step + 1):
            got["x" if calls[0] == step else "x_prev"] = args[0][..., :3].float().clone(
                memory_format=torch.contiguous_format)
        calls[0] += 1

    def pre_norm(module, args):
        if calls[0] == step + 1:
            got["h"] = args[0].clone(memory_format=torch.contiguous_format)

    handles = [unet.register_forward_pre_hook(pre_unet),
               unet.out_norm.register_forward_pre_hook(pre_norm)]
    try:
        yield got
    finally:
        for handle in handles:
            handle.remove()
    co = unet.config.out_channels // 2
    with torch.inference_mode():
        got["mult"], got["add"] = unet.out_norm.affine(got["h"])
        got["w_eps"] = unet.out_conv.weight.detach()[:co].permute(2, 3, 1, 0).contiguous()
        got["b_eps"] = unet.out_conv.bias.detach()[:co].clone()
        t = schedule.num_timesteps - 1 - step
        got["coefs"] = torch.stack(ancestral.ddim_coefficients(schedule, t)).float().to(
            got["h"].device)
