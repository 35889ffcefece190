"""The port's img2img slice against the JAX package: the VAE encoder at 256²,
the Gaussian posterior (`core/distributions`), `q_sample`, and
`build_img2img` end to end, plus the img2img CLI.

Tiny SD2-flavoured models carry the same seeded weights in both packages
(tests/torch_parity.py). At 256² the encoder's mid attention has 32² = 1024
tokens, so it crosses the attention kernel gate. img2img runs strength 0.5,
DDIM-10 (5 UNet evals), CFG 9.0, batch 2, with the posterior noise and the
q_sample noise given explicitly to both packages (the JAX side is the
composition of the JAX pipeline's steps with those noises in place of its
key draws). Encoder moments agree to 1e-4 abs, final latents to 1e-3 abs,
uint8 images to 1 LSB, as in the txt2img test.
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
from minddiffusion_tpu.pipelines.stable_diffusion import _make_eps_fn, _run_sampler
from minddiffusion_tpu.samplers import ddim as jax_ddim
from minddiffusion_tpu_torch.cli import common as cli_common
from minddiffusion_tpu_torch.cli.img2img import main as img2img_main
from minddiffusion_tpu_torch.core import distributions
from minddiffusion_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline

SIZE, STEPS, STRENGTH, BATCH, SCALE = 256, 10, 0.5, 2, 9.0


@pytest.fixture(scope="module")
def setup():
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=4)
    rng = np.random.default_rng(8)
    init = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    tokens = rng.integers(0, 1000, (BATCH, 77)).astype(np.int32)
    uncond = np.zeros((BATCH, 77), np.int32)
    enc_noise, noise = (rng.standard_normal((BATCH, SIZE // 8, SIZE // 8, 4))
                        .astype(np.float32) for _ in range(2))
    pm = tp.port_models(jm, params, attn_impl="fast")
    return jm, params, pm, init, tokens, uncond, enc_noise, noise


def test_vae_encode_matches_jax_at_256(setup):
    jm, params, pm, init, *_ = setup
    ref = jm.vae.apply(params["vae"], jnp.asarray(init), method=jm.vae.encode)
    with torch.no_grad():
        got = pm.vae.encode(tp.t(init))
    assert got.shape == (BATCH, SIZE // 8, SIZE // 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_distributions_match_jax():
    rng = np.random.default_rng(9)
    moments = rng.normal(0, 20, (2, 3, 5, 8)).astype(np.float32)   # logvar past the clamp
    eps = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    mean, logvar = jax_dist.split_moments(jnp.asarray(moments))
    pmean, plogvar = distributions.split_moments(tp.t(moments))
    np.testing.assert_array_equal(pmean.numpy(), np.asarray(mean))
    np.testing.assert_array_equal(plogvar.numpy(), np.asarray(logvar))
    assert plogvar.min() == -30.0 and plogvar.max() == 20.0
    ref = mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps)
    np.testing.assert_allclose(distributions.sample(tp.t(moments), eps=tp.t(eps)).numpy(),
                               np.asarray(ref), rtol=1e-6)
    np.testing.assert_array_equal(distributions.mode(tp.t(moments)).numpy(),
                                  np.asarray(jax_dist.mode(jnp.asarray(moments))))
    np.testing.assert_allclose(distributions.kl(tp.t(moments)).numpy(),
                               np.asarray(jax_dist.kl(jnp.asarray(moments))), rtol=1e-5)
    a = distributions.sample(tp.t(moments), torch.Generator().manual_seed(0))
    b = distributions.sample(tp.t(moments), torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (2, 3, 5, 4)
    with pytest.raises(ValueError):
        distributions.sample(tp.t(moments), eps=torch.zeros(1, 3, 5, 4))


def test_q_sample_matches_jax(setup):
    jm, _, pm, *_ = setup
    rng = np.random.default_rng(10)
    x0, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 501, 999], np.int32)
    ref = jm.schedule.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = pm.schedule.q_sample(tp.t(x0), tp.t(t), tp.t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_img2img_matches_jax(setup):
    jm, params, pm, init, tokens, uncond, enc_noise, noise = setup
    t_enc = int(STRENGTH * STEPS)
    t_at = int(jax_ddim.build_tables(jm.schedule, STEPS)["t"][STEPS - t_enc])

    @jax.jit
    def jax_run(params):
        ctx2 = jm.text_encoder.apply(params["text"], jnp.concatenate(
            [jnp.asarray(uncond), jnp.asarray(tokens)]))
        eps_fn = _make_eps_fn(jm, params, ctx2, SCALE)
        moments = jm.vae.apply(params["vae"], jnp.asarray(init), method=jm.vae.encode)
        mean, logvar = jax_dist.split_moments(moments)
        z0 = jax_latents.scale_latents(mean + jnp.exp(0.5 * logvar) * enc_noise,
                                       jm.scale_factor)
        x_mid = jm.schedule.q_sample(z0, jnp.full((BATCH,), t_at, jnp.int32), noise)
        z = _run_sampler("ddim", eps_fn, x_mid, jm.schedule, STEPS,
                         jax.random.PRNGKey(0), t_start_index=t_enc)
        img = jm.vae.apply(params["vae"], jax_latents.unscale_latents(z, jm.scale_factor),
                           method=jm.vae.decode)
        return z, jax_latents.unit_range_to_uint8(img)

    z_ref, img_ref = (np.asarray(a) for a in jax_run(params))
    fn = StableDiffusionPipeline(pm).build_img2img(SIZE, SIZE, STEPS, STRENGTH,
                                                   guidance_scale=SCALE)
    args = (pm, tp.t(init), tp.t(tokens), tp.t(uncond), None)
    z = fn.latents(*args, enc_noise=tp.t(enc_noise), noise=tp.t(noise)).numpy()
    img = fn(*args, enc_noise=tp.t(enc_noise), noise=tp.t(noise)).numpy()
    assert np.abs(z_ref).max() > 0.1
    np.testing.assert_allclose(z, z_ref, atol=1e-3, rtol=0)
    assert img.shape == (BATCH, SIZE, SIZE, 3) and img.dtype == np.uint8
    assert np.abs(img.astype(np.int32) - img_ref.astype(np.int32)).max() <= 1


def test_img2img_checks_strength_and_init_shape(setup):
    _, _, pm, init, tokens, uncond, *_ = setup
    pipe = StableDiffusionPipeline(pm)
    for strength in (0.0, 1.5):
        with pytest.raises(ValueError, match="strength"):
            pipe.build_img2img(SIZE, SIZE, STEPS, strength)
    with pytest.raises(ValueError, match="0 denoise steps"):
        pipe.build_img2img(SIZE, SIZE, STEPS, 0.05)
    fn = pipe.build_img2img(SIZE, SIZE, STEPS, STRENGTH)
    with pytest.raises(ValueError, match="init_image"):
        fn(pm, tp.t(init[:, :64]), tp.t(tokens), tp.t(uncond), None)


class _StubTokenizer:
    def tokenize(self, texts):
        return np.stack([np.full(77, len(t) % 50, np.int32) for t in texts])


def test_img2img_cli_end_to_end(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli_common, "tokenizer_for", lambda family: _StubTokenizer())
    init_path = str(tmp_path / "init.png")
    pixels = np.random.default_rng(0).integers(0, 256, (40, 56, 3), np.uint8)
    Image.fromarray(pixels).save(init_path)
    outdir = str(tmp_path / "samples")
    argv = ["--prompt", "a watercolor harbour", "--init_image", init_path,
            "--strength", "0.5", "--debug_tiny", "--device", "cpu",
            "--sampling_steps", "4", "--H", "64", "--W", "64", "--n_samples", "2",
            "--outdir", outdir]
    paths = img2img_main(argv)
    again = img2img_main(argv)
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths + again)
    a, b = (np.asarray(Image.open(p)) for p in (paths[0], again[0]))
    assert a.shape == (64, 64, 3) and np.array_equal(a, b)     # same seed, same image
    assert "saved 2 images" in capsys.readouterr().out
