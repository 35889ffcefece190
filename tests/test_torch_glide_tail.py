"""The fused sampler tail K9 (`ops/glide_tail.py`): its plain version against
the JAX package's `ddim_tail_step` / `sd_cfg_tail_step`
(benchmarks/research/glide_tail.py) in interpret mode, in both modes, at
(8, 16, 16, 32); and against the port's own unfused GLIDE super-res step on
the features of a real (tiny, fp32) SR UNet eval.

Tolerances: fp32 features 1e-5 relative to the largest magnitude of the
reference; bf16 features 2e-3 (the SiLU output is rounded to bf16 on both
sides, and a value on a rounding boundary may round the other way after
the two frameworks' fp32 sigmoids differ in the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from benchmarks.research import glide_tail as jax_tail
from minddiffusion_tpu_torch.models.glide import GlideUNetConfig, XfConfig
from minddiffusion_tpu_torch.ops import glide_tail
from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideCascadePipeline, GlideModels

B, H, W, C = 8, 16, 16, 32


def inputs(seed: int, co: int, bh: int = B, bx: int = B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(h=f(bh, H, W, C), x=f(bx, H, W, co), mult=1.0 + 0.2 * f(bh, C),
                add=0.2 * f(bh, C), w_eps=f(3, 3, C, co) * (9 * C) ** -0.5,
                b_eps=0.1 * f(co))


def assert_rel(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-3)])
@pytest.mark.parametrize("mode", ["glide", "sd"])
def test_tail_plain_matches_the_jax_kernel(mode, dtype, tol):
    co = 3 if mode == "glide" else 4
    a = inputs(1, co, bx=B if mode == "glide" else B // 2)
    coefs = np.array([1.7, 0.9, 0.8, 0.4] if mode == "glide" else [5.0, 1.02, -0.3, 0.0],
                     np.float32)
    jax_fn = jax_tail.ddim_tail_step if mode == "glide" else jax_tail.sd_cfg_tail_step
    jh = jnp.asarray(a["h"]).astype(getattr(jnp, dtype))
    ref = jax_fn(jh, *(jnp.asarray(a[k]) for k in ("x", "mult", "add", "w_eps", "b_eps")),
                 jnp.asarray(coefs), interpret=True)
    th = tp.t(a["h"]).to(getattr(torch, dtype))
    before = glide_tail.tail_step.launches
    got = glide_tail.tail_step(th, *(tp.t(a[k]) for k in ("x", "mult", "add", "w_eps", "b_eps")),
                               tp.t(coefs), mode)
    assert glide_tail.tail_step.launches == before        # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == a["x"].shape
    assert_rel(got.numpy(), ref, tol)


def test_tail_named_wrappers_and_mode_check():
    a = {k: tp.t(v) for k, v in inputs(2, 4, bx=B // 2).items()}
    coefs = torch.tensor([3.0, 1.0, -0.5, 0.0])
    assert glide_tail.PLAIN == {"glide": glide_tail.ddim_tail_step_plain,
                                "sd": glide_tail.sd_cfg_tail_step_plain}
    torch.testing.assert_close(glide_tail.tail_step(**a, coefs=coefs, mode="sd"),
                               glide_tail.sd_cfg_tail_step_plain(**a, coefs=coefs))
    with pytest.raises(ValueError, match="mode"):
        glide_tail.tail_step(*a.values(), coefs, "bogus")


def test_tail_plain_equals_the_ports_unfused_sr_step():
    """K9's "glide" mode on the out_norm input of a tiny fp32 SR UNet eval,
    caught mid-run by `glide_tail.sr_tail_probe`, gives the x the sampler's own step
    hands the next eval."""
    unet = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_head_channels=16)
    models = GlideModels.create(
        dtype=torch.float32, device="cpu", base_respacing="2", sr_respacing="ddim4",
        base_unet=GlideUNetConfig(**unet), sr_unet=GlideUNetConfig(in_channels=6, **unet),
        xf=XfConfig(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64), with_srgan=False,
        generator=torch.Generator().manual_seed(0))
    fn = GlideCascadePipeline(models).build_generate(batch_size=2, base_size=16, sr_size=32)
    tokens = torch.ones(2, 8, dtype=torch.long)
    img64 = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    for step in (1, 2):
        with glide_tail.sr_tail_probe(models.super_res.unet, models.sr_schedule, step) as probe:
            fn.sr_stage(models, img64, tokens, tokens, torch.Generator().manual_seed(2), None)
        args = [probe[k] for k in ("h", "x", "mult", "add", "w_eps", "b_eps", "coefs")]
        assert all(a.is_contiguous() for a in args)         # as the kernel takes them
        got = glide_tail.tail_step(*args, mode="glide")
        assert_rel(got.numpy(), probe["x_prev"].numpy(), 1e-5)


# (shape, co, mode, stages, CTAs, tiles, channel chunks, shared bytes):
# chip_smoke phase 16's two cases, then the card tests' C not a multiple of
# 64 and H, W not multiples of the 32 x 8 tile
PLAN_SITES = [
    ((8, 256, 256, 192), 3, "glide", 4, 132, 2048, 3, 226656),
    ((16, 64, 64, 320), 4, "sd", 3, 128, 128, 10, 208304),
    ((2, 13, 37, 200), 4, "glide", 3, 8, 8, 4, 203184),
    ((4, 20, 11, 40), 4, "sd", 4, 6, 6, 2, 231872),
    ((2, 9, 33, 40), 3, "sd", 4, 4, 4, 2, 218464),
    ((1, 17, 9, 64), 3, "glide", 4, 3, 3, 1, 218464),
]


@pytest.mark.parametrize("shape,co,mode,stages,ctas,tiles,chunks,smem", PLAN_SITES)
def test_tail_plan_at_both_modes(shape, co, mode, stages, ctas, tiles, chunks, smem):
    """K9's plan (csrc/glide_tail.cu): persistent CTAs, one an SM, over an
    image's 32 x 8 output tiles (both CFG halves in one tile in "sd"), the
    products over each tile's 34 x 10 halo box, W^T's 27 or 36 rows padded
    to 32 or 40, the deepest ring shared memory holds."""
    plan = glide_tail.tail_plan(shape, co, mode)
    bh, h, w, c = shape
    assert (plan.stages, plan.ctas, plan.tiles, plan.chunks, plan.smem) == (
        stages, ctas, tiles, chunks, smem)
    assert plan.tile == (32, 8) and plan.rows == {3: 32, 4: 40}[co] >= 9 * co
    assert plan.tiles == -(-w // 32) * -(-h // 8) * (bh // 2 if mode == "sd" else bh)
    assert plan.ctas == min(plan.tiles, glide_tail.SMS) and plan.waves == plan.tiles / plan.ctas
    assert plan.smem <= glide_tail.SMEM_MAX and plan.halo == pytest.approx(
        -(-w // 32) * -(-h // 8) * 340 / (h * w))


def test_tail_plan_refuses_what_the_kernel_does_not_take():
    for args in [((2, 8, 8, 36), 3, "glide"), ((2, 8, 8, 64), 5, "glide"),
                 ((3, 8, 8, 64), 4, "sd"), ((2, 8, 8, 64), 3, "bogus")]:
        with pytest.raises(ValueError):
            glide_tail.tail_plan(*args)
    for c, co in [(1600, 3), (1152, 4)]:          # the widest C shared memory holds
        assert glide_tail.tail_plan((2, 8, 8, c), co, "sd").stages == 2
        with pytest.raises(ValueError, match="shared memory"):
            glide_tail.tail_plan((2, 8, 8, c + 8), co, "sd")
