"""Port core/ and samplers/ vs the JAX package, on seeded numpy inputs (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddiffusion_tpu.core import cfg as jax_cfg
from minddiffusion_tpu.core import latents as jax_latents
from minddiffusion_tpu.core import schedules as jax_schedules
from minddiffusion_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from minddiffusion_tpu.samplers import ddim as jax_ddim
from minddiffusion_tpu.samplers import plms as jax_plms
from minddiffusion_tpu_torch.core import cfg, latents
from minddiffusion_tpu_torch.core import schedules as schedules_lib
from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule, make_ddim_timesteps
from minddiffusion_tpu_torch.samplers import ddim, plms


def schedules():
    return (JaxSchedule.create("linear", 1000, 0.00085, 0.0120),
            DiffusionSchedule.create(1000, 0.00085, 0.0120))


def test_schedule_tables_match_jax():
    js, ts = schedules()
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert ts.num_timesteps == js.num_timesteps == 1000


@pytest.mark.parametrize("steps,eta", [(50, 0.0), (10, 0.5), (7, 0.0), (600, 0.0)])
def test_ddim_tables_match_jax(steps, eta):
    js, ts = schedules()
    ref = jax_ddim.build_tables(js, steps, eta)
    got = ddim.build_tables(ts, steps, eta)
    for k in ("t", "alpha", "alpha_prev", "sigma"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_ddim_timesteps_reject_out_of_range():
    with pytest.raises(ValueError):
        make_ddim_timesteps(0)


def test_cfg_fold_duplicate_guide_match_jax():
    rng = np.random.default_rng(0)
    u, c = (rng.standard_normal((2, 3, 5)).astype(np.float32) for _ in range(2))
    folded = cfg.fold(torch.from_numpy(u), torch.from_numpy(c))
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jax_cfg.fold(u, c)))
    np.testing.assert_array_equal(cfg.duplicate(torch.from_numpy(u)).numpy(),
                                  np.asarray(jax_cfg.duplicate(jnp.asarray(u))))
    np.testing.assert_allclose(cfg.guide(folded, 9.0).numpy(),
                               np.asarray(jax_cfg.guide(jnp.asarray(folded.numpy()), 9.0)),
                               atol=1e-6)


def test_unit_range_to_uint8_matches_jax_round_half_even():
    x = np.array([-2.0, -1.0, 1.0 / 255.0 - 1.0, 0.0, 3.0 / 255.0 - 1.0, 1.0, 5.0],
                 np.float32)
    x = np.concatenate([x, np.random.default_rng(1).uniform(-1.2, 1.2, 200).astype(np.float32)])
    got = latents.unit_range_to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_latents.unit_range_to_uint8(jnp.asarray(x))))
    np.testing.assert_allclose(latents.unscale_latents(torch.ones(2)).numpy(),
                               np.asarray(jax_latents.unscale_latents(jnp.ones(2))))


def _toy_eps(mod):
    """eps(x, t) = tanh(0.7 x + t / 1000) - 0.1 x, in either framework."""
    return lambda x, t: mod.tanh(0.7 * x + t.reshape(-1, 1, 1, 1) / 1000.0) - 0.1 * x


@pytest.mark.parametrize("steps", [4, 10])
@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_samplers_match_jax(sampler, steps):
    js, ts = schedules()
    x_T = np.random.default_rng(2).standard_normal((2, 4, 4, 3)).astype(np.float32)
    jax_fn = {"ddim": jax_ddim.sample, "plms": jax_plms.sample}[sampler]
    fn = {"ddim": ddim.sample, "plms": plms.sample}[sampler]
    ref = jax_fn(_toy_eps(jnp), jnp.asarray(x_T), js, num_steps=steps)
    got = fn(_toy_eps(torch), torch.from_numpy(x_T), ts, num_steps=steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_ddim_partial_chain_matches_jax():
    js, ts = schedules()
    x = np.random.default_rng(3).standard_normal((1, 4, 4, 3)).astype(np.float32)
    ref = jax_ddim.sample(_toy_eps(jnp), jnp.asarray(x), js, num_steps=10, t_start_index=4)
    got = ddim.sample(_toy_eps(torch), torch.from_numpy(x), ts, num_steps=10, t_start_index=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_ddim_mask_blend_keeps_the_known_region():
    """mask == 1 everywhere and eps == 0: every step restarts from
    q_sample(x0, t) with the generator's noise, so the result is the last
    step's DDIM map of that sample."""
    _, ts = schedules()
    x0 = torch.full((1, 2, 2, 1), 0.5)
    zero_eps = lambda x, t: torch.zeros_like(x)  # noqa: E731
    out = ddim.sample(zero_eps, torch.zeros(1, 2, 2, 1), ts, num_steps=5,
                      mask=torch.ones_like(x0), x0=x0,
                      generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    noise = [torch.randn(x0.shape, generator=g) for _ in range(5)][-1]
    tab = ddim.build_tables(ts, 5)
    t_last = int(tab["t"][-1])
    x = ts.sqrt_alphas_cumprod[t_last] * x0 + ts.sqrt_one_minus_alphas_cumprod[t_last] * noise
    expect = torch.sqrt(torch.tensor(tab["alpha_prev"][-1])) * x / torch.sqrt(
        torch.tensor(tab["alpha"][-1]))
    torch.testing.assert_close(out, expect, atol=1e-6, rtol=0)


def test_ddim_eta_draws_from_the_generator():
    _, ts = schedules()
    x_T = torch.zeros(1, 2, 2, 1)
    run = lambda seed: ddim.sample(_toy_eps(torch), x_T, ts, num_steps=5, eta=1.0,  # noqa: E731
                                   generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError):
        plms.sample(_toy_eps(torch), x_T, ts, eta=0.5)


SCHEDULE_TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                   "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                   "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                   "posterior_log_variance_clipped", "posterior_mean_coef1",
                   "posterior_mean_coef2", "timestep_map")


def hold_schedule(got: DiffusionSchedule, ref: JaxSchedule) -> None:
    """Every table of the port's schedule within 1e-12 of the JAX one (both
    fp32 from the same float64 math: equal)."""
    assert got.num_timesteps == ref.num_timesteps
    for name in SCHEDULE_TABLES:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-12, rtol=0, err_msg=name)


@pytest.mark.parametrize("v_posterior", [0.0, 0.1])
@pytest.mark.parametrize("name", ["linear", "quad", "linear_plain", "squaredcos_cap_v2"])
def test_beta_schedules_and_create_match_jax(name, v_posterior):
    """make_beta_schedule (float64) and DiffusionSchedule.create with the
    JAX keywords, `v_posterior` in the posterior variance."""
    kw = dict(n_timestep=1000, linear_start=0.00085, linear_end=0.0120)
    betas = schedules_lib.make_beta_schedule(schedule=name, **kw)
    ref = jax_schedules.make_beta_schedule(name, **kw)
    assert betas.dtype == np.float64
    np.testing.assert_allclose(betas, ref, atol=1e-12, rtol=0)
    hold_schedule(DiffusionSchedule.create(schedule=name, v_posterior=v_posterior, **kw),
                  JaxSchedule.create(name, v_posterior=v_posterior, **kw))


def test_schedule_create_keeps_the_positional_form():
    """The port's positional order (n_timestep first) still builds SD's
    linear schedule, equal to the JAX keyword call."""
    hold_schedule(DiffusionSchedule.create(1000, 0.00085, 0.0120),
                  JaxSchedule.create(schedule="linear", n_timestep=1000,
                                     linear_start=0.00085, linear_end=0.0120))
    with pytest.raises(ValueError, match="unknown beta schedule"):
        DiffusionSchedule.create(schedule="cosine")


@pytest.mark.parametrize("v_posterior", [0.0, 0.1])
@pytest.mark.parametrize("spacing", ["ddim25", "fast27", "10,5"])
def test_respace_schedule_with_v_posterior_matches_jax(spacing, v_posterior):
    betas = schedules_lib.make_beta_schedule(1000, schedule="squaredcos_cap_v2")
    use = schedules_lib.space_timesteps(1000, spacing)
    hold_schedule(schedules_lib.respace_schedule(betas, use, v_posterior=v_posterior),
                  jax_schedules.respace_schedule(betas, use, v_posterior=v_posterior))


@pytest.mark.parametrize("method", ["uniform", "quad"])
def test_ddim_timesteps_by_method_match_jax(method):
    for s in (1, 2, 7, 10, 50, 100, 333, 501, 1000):
        got = make_ddim_timesteps(s, 1000, method)
        ref = jax_schedules.make_ddim_timesteps(s, 1000, method)
        assert got.dtype == ref.dtype == np.int64
        np.testing.assert_array_equal(got, ref, err_msg=f"S={s}")
    np.testing.assert_array_equal(make_ddim_timesteps(20, 500, method=method),
                                  jax_schedules.make_ddim_timesteps(20, 500, method=method))


def test_ddim_timesteps_refuse_an_unknown_method():
    for fn in (make_ddim_timesteps, jax_schedules.make_ddim_timesteps):
        with pytest.raises(ValueError, match="unknown ddim discretization"):
            fn(10, 1000, "cosine")


@pytest.mark.parametrize("steps,eta", [(10, 0.0), (25, 0.0), (8, 0.5)])
def test_ddim_quad_tables_match_jax(steps, eta):
    js, ts = schedules()
    ref = jax_ddim.build_tables(js, steps, eta, method="quad")
    got = ddim.build_tables(ts, steps, eta, method="quad")
    for k in ("t", "alpha", "alpha_prev", "sigma"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not np.array_equal(got["t"], ddim.build_tables(ts, steps, eta)["t"])


@pytest.mark.parametrize("steps", [5, 12])
def test_ddim_quad_sample_matches_jax(steps):
    """ddim.sample(method="quad") on the toy eps, as the uniform chain is
    held above (1e-5)."""
    js, ts = schedules()
    x_T = np.random.default_rng(5).standard_normal((2, 4, 4, 3)).astype(np.float32)
    ref = jax_ddim.sample(_toy_eps(jnp), jnp.asarray(x_T), js, num_steps=steps, method="quad")
    got = ddim.sample(_toy_eps(torch), torch.from_numpy(x_T), ts, num_steps=steps,
                      method="quad")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    uniform = ddim.sample(_toy_eps(torch), torch.from_numpy(x_T), ts, num_steps=steps)
    assert (got - uniform).abs().max() > 1e-3
