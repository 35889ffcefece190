"""The port's inpaint slice against the JAX package: the latent mask resize,
the DPM samplers' mask/x0 blending, `build_inpaint` end to end through the
tiny 9-channel Wukong-Huahua models, and the inpaint CLI.

`build_inpaint` runs PLMS-4 (5 UNet evals), CFG 7.5, batch 2, at 256^2
with the posterior noise and x_T given explicitly to both packages (the
JAX side is the composition of the JAX pipeline's steps with those noises
in place of its key draws), and a mask whose half-pixel nearest resize
(JAX's "nearest", torch's "nearest-exact") differs from torch's "nearest"
at every latent pixel. Tolerances: latents 1e-4 of their largest magnitude
(~15 here; fp32 sums in another order); uint8 images 1 level; the sampler
blending 1e-5 of the largest magnitude (fp32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from minddiffusion_tpu.core import distributions as jax_dist
from minddiffusion_tpu.core import latents as jax_latents
from minddiffusion_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from minddiffusion_tpu.pipelines.stable_diffusion import _make_eps_fn, _run_sampler
from minddiffusion_tpu.samplers import dpm_solver as jax_dpm
from minddiffusion_tpu_torch.cli import common as cli_common
from minddiffusion_tpu_torch.cli.inpaint import main as inpaint_main, mask_array
from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.pipelines import stable_diffusion as port_pipe
from minddiffusion_tpu_torch.samplers import dpm_solver

SIZE, STEPS, BATCH, SCALE = 256, 4, 2, 7.5


def half_pixel_mask(b: int, size: int) -> np.ndarray:
    """1 on the columns x % 8 >= 4 of the top half, else 0: the latent pixel
    i reads image pixel 8i + 4 (half-pixel nearest), which is 1 in the top
    half, while torch's "nearest" reads 8i, which is 0 everywhere."""
    m = np.zeros((b, size, size, 1), np.float32)
    cols = (np.arange(size) % 8) >= 4
    m[:, : size // 2, cols] = 0.9          # >= 0.5: binarised to 1
    return m


def test_latent_mask_resize_is_half_pixel_nearest():
    mask = half_pixel_mask(1, 16)
    ref = np.asarray(jax.image.resize(jnp.asarray(mask >= 0.5, jnp.float32),
                                      (1, 2, 2, 1), "nearest"))
    m = torch.from_numpy((mask >= 0.5).astype(np.float32)).permute(0, 3, 1, 2)
    exact = torch.nn.functional.interpolate(m, size=(2, 2), mode="nearest-exact")
    plain = torch.nn.functional.interpolate(m, size=(2, 2), mode="nearest")
    np.testing.assert_array_equal(exact.permute(0, 2, 3, 1).numpy(), ref)
    assert ref[0, 0, :, 0].tolist() == [1.0, 1.0] and plain.sum() == 0


# ---- DPM-Solver with mask / x0 ---------------------------------------------

RNG = np.random.default_rng(21)
W, B = RNG.uniform(0.5, 1.5, 4).astype(np.float32), RNG.uniform(-1, 1, 4).astype(np.float32)
X_T = RNG.standard_normal((2, 6, 5, 4)).astype(np.float32)
X0 = RNG.standard_normal((2, 6, 5, 4)).astype(np.float32)
KEEP = np.zeros((2, 6, 5, 1), np.float32)
KEEP[:, :3] = 1.0                       # mask == 1: the known region


def jax_eps(x, t):
    return jnp.tanh(x * W + B * jnp.sin(t.astype(jnp.float32)[0] * 0.003))


def port_eps(x, t):
    return torch.tanh(x * torch.from_numpy(W) + torch.from_numpy(B)
                      * torch.sin(t.float()[0] * 0.003))


@pytest.mark.parametrize("solver,steps", [("sample", 10), ("sample_singlestep", 7)])
def test_dpm_mask_x0_blending_matches_jax(solver, steps):
    """The eps model acts pixel by pixel, so the repainted region (mask 0)
    follows the same trajectory whatever the blend noise: it must match the
    JAX solver. The known region (mask 1) ends as the last blend left it:
    q_sample(x0, 0) with the generator's last noise draw."""
    js = JaxSchedule.create("linear", 1000, 0.00085, 0.0120)
    ps = DiffusionSchedule.create(1000, 0.00085, 0.0120)
    ref = np.asarray(getattr(jax_dpm, solver)(
        jax_eps, jnp.asarray(X_T), js, steps=steps, mask=jnp.asarray(KEEP),
        x0=jnp.asarray(X0), key=jax.random.PRNGKey(3)))
    got = getattr(dpm_solver, solver)(
        port_eps, tp.t(X_T), ps, steps=steps, mask=tp.t(KEEP), x0=tp.t(X0),
        generator=torch.Generator().manual_seed(5)).numpy()
    free = KEEP[..., 0] == 0
    tol = 1e-5 * np.abs(ref[free]).max()
    np.testing.assert_allclose(got[free], ref[free], atol=tol, rtol=0)
    blends = steps if solver == "sample" else len(
        dpm_solver.build_singlestep_groups(ps, steps))
    g = torch.Generator().manual_seed(5)
    last = [torch.randn(X0.shape, generator=g) for _ in range(blends)][-1].numpy()
    kept = float(ps.sqrt_alphas_cumprod[0]) * X0 + float(ps.sqrt_one_minus_alphas_cumprod[0]) * last
    np.testing.assert_allclose(got[~free], kept[~free], atol=1e-6, rtol=0)
    unmasked = getattr(dpm_solver, solver)(port_eps, tp.t(X_T), ps, steps=steps).numpy()
    assert np.abs(unmasked[~free] - got[~free]).max() > 0.1


def test_run_sampler_passes_the_blend_and_refuses_it_for_adaptive():
    ps = DiffusionSchedule.create(1000, 0.00085, 0.0120)
    got = port_pipe._run_sampler("dpm", port_eps, tp.t(X_T), ps, 6,
                                 torch.Generator().manual_seed(1),
                                 mask=tp.t(KEEP), x0=tp.t(X0))
    ref = dpm_solver.sample(port_eps, tp.t(X_T), ps, steps=6, mask=tp.t(KEEP),
                            x0=tp.t(X0), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="dpm_adaptive"):
        port_pipe._run_sampler("dpm_adaptive", port_eps, tp.t(X_T), ps, 6, None,
                               mask=tp.t(KEEP), x0=tp.t(X0))


# ---- build_inpaint ------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jm = tp.jax_models(family="wukong-inpaint")
    params = tp.jax_params(jm, seed=9)
    rng = np.random.default_rng(12)
    image = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    mask = half_pixel_mask(BATCH, SIZE)
    tokens = rng.integers(0, 21128, (BATCH, 77)).astype(np.int32)
    uncond = np.zeros((BATCH, 77), np.int32)
    enc_noise, noise = (rng.standard_normal((BATCH, SIZE // 8, SIZE // 8, 4))
                        .astype(np.float32) for _ in range(2))
    pm = tp.port_models(jm, params, family="wukong-inpaint")
    return jm, params, pm, image, mask, tokens, uncond, enc_noise, noise


def test_inpaint_matches_jax(setup):
    jm, params, pm, image, mask, tokens, uncond, enc_noise, noise = setup
    h8 = SIZE // 8

    @jax.jit
    def jax_run(params):
        m = (jnp.asarray(mask) >= 0.5).astype(jnp.float32)
        masked = jnp.asarray(image) * (1.0 - m)
        ctx2 = jm.text_encoder.apply(params["text"], jnp.concatenate(
            [jnp.asarray(uncond), jnp.asarray(tokens)]))
        moments = jm.vae.apply(params["vae"], masked, method=jm.vae.encode)
        mean, logvar = jax_dist.split_moments(moments)
        z_masked = jax_latents.scale_latents(mean + jnp.exp(0.5 * logvar) * enc_noise,
                                             jm.scale_factor)
        mask_lat = jax.image.resize(m, (BATCH, h8, h8, 1), "nearest")
        c_cat = jnp.concatenate([mask_lat, z_masked], axis=-1)
        eps_fn = _make_eps_fn(jm, params, ctx2, SCALE,
                              concat2b=jnp.concatenate([c_cat, c_cat], axis=0))
        z = _run_sampler("plms", eps_fn, jnp.asarray(noise), jm.schedule, STEPS,
                         jax.random.PRNGKey(0))
        img = jm.vae.apply(params["vae"], jax_latents.unscale_latents(z, jm.scale_factor),
                           method=jm.vae.decode)
        return z, jax_latents.unit_range_to_uint8(img)

    z_ref, img_ref = (np.asarray(a) for a in jax_run(params))
    fn = port_pipe.StableDiffusionPipeline(pm).build_inpaint(SIZE, SIZE, STEPS,
                                                            guidance_scale=SCALE)
    args = (pm, tp.t(image), tp.t(mask), tp.t(tokens), tp.t(uncond), None)
    z = fn.latents(*args, enc_noise=tp.t(enc_noise), noise=tp.t(noise)).numpy()
    img = fn(*args, enc_noise=tp.t(enc_noise), noise=tp.t(noise)).numpy()
    assert np.abs(z_ref).max() > 0.1
    np.testing.assert_allclose(z, z_ref, atol=1e-4 * np.abs(z_ref).max(), rtol=0)
    assert img.shape == (BATCH, SIZE, SIZE, 3) and img.dtype == np.uint8
    assert np.abs(img.astype(np.int32) - img_ref.astype(np.int32)).max() <= 1


def test_inpaint_checks_its_unet_and_inputs(setup):
    _, _, pm, image, mask, tokens, uncond, *_ = setup
    fn = port_pipe.StableDiffusionPipeline(pm).build_inpaint(SIZE, SIZE, 2)
    with pytest.raises(ValueError, match="mask"):
        fn(pm, tp.t(image), tp.t(mask[:, :64]), tp.t(tokens), tp.t(uncond), None)
    four = port_pipe.SDModels.create(family="wukong", dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="9-channel"):
        port_pipe.StableDiffusionPipeline(four).build_inpaint(SIZE, SIZE, 2)


# ---- the CLI --------------------------------------------------------------------

class _StubTokenizer:
    def tokenize(self, texts):
        return np.stack([np.full(77, len(t) % 50, np.int32) for t in texts])


def test_mask_thresholds_the_last_channel():
    """Black and white masks give what the JAX CLI's luminance mask gives
    after the pipeline's >= 0.5; a pure blue mask differs (reference
    semantics: last channel > 127.5)."""
    rgb = np.zeros((4, 4, 3), np.uint8)
    rgb[:2] = 255
    bw = mask_array(Image.fromarray(rgb))
    jax_cli = np.asarray(Image.fromarray(rgb).convert("L"), np.float32) / 255.0 >= 0.5
    np.testing.assert_array_equal(bw[0, ..., 0], jax_cli.astype(np.float32))
    blue = np.zeros((4, 4, 3), np.uint8)
    blue[..., 2] = 255
    assert mask_array(Image.fromarray(blue)).min() == 1.0
    assert (np.asarray(Image.fromarray(blue).convert("L"), np.float32) / 255.0).max() < 0.5


@pytest.mark.parametrize("aug", ["resize", "resizecrop"])
def test_inpaint_cli_end_to_end(tmp_path, capsys, monkeypatch, aug):
    monkeypatch.setattr(cli_common, "tokenizer_for", lambda family: _StubTokenizer())
    rng = np.random.default_rng(0)
    image_path, mask_path = str(tmp_path / "image.png"), str(tmp_path / "mask.png")
    Image.fromarray(rng.integers(0, 256, (80, 96, 3), np.uint8)).save(image_path)
    mask = np.zeros((80, 96, 3), np.uint8)
    mask[20:60, 30:70] = 255
    Image.fromarray(mask).save(mask_path)
    outdir = str(tmp_path / "samples")
    argv = ["--prompt", "一只猫", "--image_path", image_path, "--mask_path", mask_path,
            "--debug_tiny", "--device", "cpu", "--sampling_steps", "2", "--H", "64",
            "--W", "64", "--n_samples", "2", "--aug", aug, "--outdir", outdir]
    paths = inpaint_main(argv)
    again = inpaint_main(argv)
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths + again)
    a, b = (np.asarray(Image.open(p)) for p in (paths[0], again[0]))
    assert a.shape == (64, 64, 3) and np.array_equal(a, b)
    assert "saved 2 images" in capsys.readouterr().out
