"""The port's DPM-Solver samplers against the JAX package's.

Both packages run the same eps model, an analytic function of (x, t) written
once in each framework (the solvers see only eps_fn), on the same numpy x_T,
over the SD schedule. Multistep orders 1-3 with and without
lower_order_final, singlestep orders 1-3 with their tail groups, the
adaptive solver of orders 2 and 3; data (++) and noise prediction; dynamic
thresholding; both skip types. Final latents agree to 1e-5 of their largest
magnitude (fp32: the host scalars are rounded at other places than in the
JAX scan, and the data prediction divides by alpha ~0.07 at t = 1, so the
latents reach ~25 on this model).

The slice as a whole: `dpm` through the tiny SD2 UNet (tests/torch_parity.py)
in the port's txt2img pipeline against the JAX `_run_sampler` on the same
x_T, and the txt2img CLI with `--sampler dpm`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
import torch_parity as tp
from minddiffusion_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from minddiffusion_tpu.pipelines.stable_diffusion import _make_eps_fn, _run_sampler
from minddiffusion_tpu.samplers import dpm_solver as jax_dpm
from minddiffusion_tpu_torch.cli import common as cli_common
from minddiffusion_tpu_torch.cli.txt2img import main as txt2img_main
from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.pipelines import stable_diffusion as port_pipe
from minddiffusion_tpu_torch.samplers import dpm_solver

REL_TOL = 1e-5
RNG = np.random.default_rng(11)
W, B, C = (RNG.uniform(0.5, 1.5, 4).astype(np.float32),
           RNG.uniform(-1, 1, 4).astype(np.float32),
           RNG.uniform(0, 3, 4).astype(np.float32))
X_T = RNG.standard_normal((2, 6, 5, 4)).astype(np.float32)


def jax_eps(x, t):
    return jnp.tanh(x * W + B * jnp.sin(t.astype(jnp.float32)[0] * 0.003 + C))


def port_eps(x, t):
    w, b, c = (torch.from_numpy(a) for a in (W, B, C))
    return torch.tanh(x * w + b * torch.sin(t.float()[0] * 0.003 + c))


@pytest.fixture(scope="module")
def schedules():
    return (JaxSchedule.create("linear", 1000, 0.00085, 0.0120),
            DiffusionSchedule.create(1000, 0.00085, 0.0120))


def check(got: torch.Tensor, ref, x_T: np.ndarray = X_T) -> None:
    ref = np.asarray(ref)
    assert np.isfinite(ref).all() and np.abs(ref - x_T).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=REL_TOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("kw", [
    dict(steps=10, order=2),
    dict(steps=20, order=3),
    dict(steps=6, order=1),
    dict(steps=10, order=2, prediction="noise"),
    dict(steps=12, order=3, prediction="noise", skip_type="time_quadratic"),
    dict(steps=10, order=2, thresholding=True, thresholding_max_val=0.5),
    dict(steps=16, order=2, lower_order_final=False),
])
def test_multistep_matches_jax(schedules, kw):
    jsched, psched = schedules
    ref = jax_dpm.sample(jax_eps, jnp.asarray(X_T), jsched, **kw)
    got = dpm_solver.sample(port_eps, torch.from_numpy(X_T), psched, **kw)
    check(got, ref)


@pytest.mark.parametrize("kw", [
    dict(steps=7, order=3),
    dict(steps=8, order=3, prediction="noise"),
    dict(steps=9, order=2),
    dict(steps=6, order=2, prediction="noise"),
    dict(steps=4, order=1),
    dict(steps=9, order=3, thresholding=True),
])
def test_singlestep_matches_jax(schedules, kw):
    jsched, psched = schedules
    ref = jax_dpm.sample_singlestep(jax_eps, jnp.asarray(X_T), jsched, **kw)
    got = dpm_solver.sample_singlestep(port_eps, torch.from_numpy(X_T), psched, **kw)
    check(got, ref)


@pytest.mark.parametrize("kw", [dict(order=3), dict(order=2),
                                dict(order=3, prediction="noise")])
def test_adaptive_matches_jax(schedules, kw):
    jsched, psched = schedules
    ref = jax_dpm.sample_adaptive(jax_eps, jnp.asarray(X_T), jsched, **kw)
    got = dpm_solver.sample_adaptive(port_eps, torch.from_numpy(X_T), psched, **kw)
    check(got, ref)


# Four rows, the second half at three times the noise scale: on their own
# the halves take other steps than the whole batch (24 model calls for
# the whole batch and the first half, 21 for the second; up to 0.16 apart
# in rows 2-3).
X_GRID = np.random.default_rng(12).standard_normal((4, 6, 5, 4)).astype(np.float32)
X_GRID[2:] *= 3.0


def test_adaptive_over_two_data_ranks_steps_as_the_whole_batch(schedules, tmp_path):
    """sample_adaptive with the batch split over two data ranks (gloo, a
    dp 2 grid, tests/torch_dist.py): the error norm is the max over both
    ranks' rows, so each rank's rows are bytewise the one-process call's
    on the whole batch, within the file's tolerance of the JAX solver on
    the whole batch, after the whole batch's model calls. The halves run
    apart (no group) step otherwise, which the split must not."""
    args = (X_GRID, W, B, C)
    session = td.start_ranks([(td.adaptive, (*args, (2, 1, 1)))], 2, tmp_path, timeout=120)
    one, nfe = td.adaptive(*args, None)
    halves = [td.adaptive(X_GRID[i:i + 2], W, B, C, None) for i in (0, 2)]
    ref = np.asarray(jax_dpm.sample_adaptive(jax_eps, jnp.asarray(X_GRID), schedules[0]))
    ranks = [r[0] for r in session.join()]
    assert [n for _, n in halves] != [nfe, nfe]
    check(one, ref, X_GRID)
    for r, (rows, n) in enumerate(ranks):
        assert n == nfe, (r, n, nfe)
        assert torch.equal(rows, one[2 * r:2 * r + 2]), r
        np.testing.assert_allclose(rows.numpy(), ref[2 * r:2 * r + 2],
                                   atol=REL_TOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("sampler", ["dpm", "dpm_singlestep", "dpm_adaptive"])
def test_run_sampler_matches_jax(schedules, sampler):
    jsched, psched = schedules
    ref = _run_sampler(sampler, jax_eps, jnp.asarray(X_T), jsched, 8,
                       jax.random.PRNGKey(0))
    got = port_pipe._run_sampler(sampler, port_eps, torch.from_numpy(X_T), psched, 8,
                                 None)
    check(got, ref)


def test_run_sampler_keeps_the_reference_refusals(schedules):
    _, psched = schedules
    x = torch.from_numpy(X_T)
    for sampler in ("plms", "dpm", "dpm_singlestep", "dpm_adaptive"):
        with pytest.raises(ValueError, match="t_start_index"):
            port_pipe._run_sampler(sampler, port_eps, x, psched, 8, None, t_start_index=4)
    with pytest.raises(ValueError, match="thresholding"):
        dpm_solver.sample(port_eps, x, psched, steps=4, prediction="noise",
                          thresholding=True)
    with pytest.raises(ValueError, match="unknown sampler"):
        port_pipe._run_sampler("euler", port_eps, x, psched, 8, None)


def test_dpm_txt2img_through_the_unet_matches_jax():
    """Continuous model times through the UNet's time embedding: 128² images
    (16² latents), 6 steps, CFG 9.0, batch 1."""
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=5)
    pm = tp.port_models(jm, params)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    uncond = np.zeros((1, 77), np.int32)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)

    @jax.jit
    def jax_latent(params):
        ctx2 = jm.text_encoder.apply(params["text"], jnp.asarray(np.concatenate([uncond, tokens])))
        eps_fn = _make_eps_fn(jm, params, ctx2, 9.0)
        return _run_sampler("dpm", eps_fn, jnp.asarray(noise), jm.schedule, 6,
                            jax.random.PRNGKey(0))

    ref = np.asarray(jax_latent(params))
    fn = port_pipe.StableDiffusionPipeline(pm).build_txt2img(128, 128, 6, "dpm", 9.0, 1)
    got = fn.latents(pm, tp.t(tokens), tp.t(uncond), None, noise=tp.t(noise))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


class _StubTokenizer:
    def tokenize(self, texts):
        return np.stack([np.full(77, len(t) % 50, np.int32) for t in texts])


def test_txt2img_cli_with_dpm(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli_common, "tokenizer_for", lambda family: _StubTokenizer())
    outdir = str(tmp_path / "samples")
    paths = txt2img_main([
        "--prompt", "a lighthouse", "--debug_tiny", "--device", "cpu",
        "--sampler", "dpm", "--sampling_steps", "3", "--H", "64", "--W", "64",
        "--n_samples", "2", "--outdir", outdir])
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    assert "the infer time of a batch is" in capsys.readouterr().out
