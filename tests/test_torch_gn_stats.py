"""The channel-sums kernel K6 (`ops/gn_stats.py`): its plain version against
the JAX package's `channel_sums_pallas` / `channel_sums_pallas_t`
(benchmarks/research/gn_stats.py) in interpret mode, its analytic VJP
against `jax.vjp` of `channel_sums`, and the sums `GroupNorm32.affine`
builds every GroupNorm from.

Tolerances: the sums are fp32 on both sides over at most 256 values, so
1e-5 relative to the largest magnitude; the VJP (elementwise fp32) 1e-6,
and 4e-3 in bf16, where both sides round dx to bf16 once (half an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.research import gn_stats as jax_gn
from minddiffusion_tpu_torch.models.layers import GroupNorm32, gn_affine_from_sums
from minddiffusion_tpu_torch.ops import gn_stats

SHAPES = [(2, 8, 8, 64), (3, 4, 16, 40), (1, 16, 16, 8)]


def assert_rel(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


def draw(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.dtype(dtype)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernels(shape, dtype):
    """Both JAX kernels (standard and transposed read) against the plain
    version on the same (bf16-representable) values."""
    x = draw(shape, 0, dtype)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    s1, s2 = gn_stats.channel_sums_plain(xt)
    for fn in (jax_gn.channel_sums_pallas, jax_gn.channel_sums_pallas_t):
        j1, j2 = fn(xj, interpret=True)
        assert_rel(s1, j1, 1e-5)
        assert_rel(s2, j2, 1e-5)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == (shape[0], shape[3])


@pytest.mark.parametrize("transposed", [False, True])
def test_wrapper_on_cpu_and_both_memory_orders(transposed):
    x = torch.from_numpy(draw((3, 6, 10, 16), 1, "float32")).to(torch.bfloat16)
    if transposed:    # (B, H, W, C) view of (H, W, B, C) memory
        x = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
        assert gn_stats._strides(x, True) == (16, 3 * 16)
        with pytest.raises(ValueError, match="memory"):
            gn_stats._strides(x, False)
    else:
        assert gn_stats._strides(x, False) == (6 * 10 * 16, 16)
        with pytest.raises(ValueError, match="memory"):
            gn_stats._strides(x, True)
    s1, s2 = gn_stats.channel_sums(x, transposed)
    r1, r2 = gn_stats.channel_sums_plain(x)
    assert torch.equal(s1, r1) and torch.equal(s2, r2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_jax(dtype):
    """dx = g1 + 2 x g2 in fp32, cast to x's dtype (gn_stats.py:200-203)."""
    shape = (2, 4, 6, 24)
    x = draw(shape, 2, dtype)
    rng = np.random.default_rng(3)
    g1 = rng.standard_normal((2, 24)).astype(np.float32)
    g2 = rng.standard_normal((2, 24)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    _, vjp = jax.vjp(lambda a: jax_gn.channel_sums(a), xj)
    (dj,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    s1, s2 = gn_stats.channel_sums(xt)
    (dt,) = torch.autograd.grad((s1, s2), (xt,), (torch.from_numpy(g1), torch.from_numpy(g2)))
    assert dt.dtype == xt.dtype
    assert_rel(dt.float(), np.asarray(dj, np.float32), 1e-6 if dtype == "float32" else 4e-3)
    # one output alone: the other cotangent is zero
    (d1,) = torch.autograd.grad(gn_stats.channel_sums(xt)[0].sum(), (xt,))
    assert torch.equal(d1, torch.ones_like(d1))


def test_groupnorm_affine_is_built_from_these_sums():
    norm = GroupNorm32(64)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1)
        norm.bias.normal_(0.0, 0.1)
    x = torch.from_numpy(draw((2, 8, 8, 64), 4, "float32"))
    s1, s2 = gn_stats.channel_sums(x)
    r1, r2 = norm.stat_sums(x)
    assert torch.equal(s1, r1) and torch.equal(s2, r2)
    mult, add = gn_affine_from_sums(s1, s2, 64, norm.weight, norm.bias, norm.num_groups,
                                    norm.eps)
    np.testing.assert_allclose((x * mult[:, None, None] + add[:, None, None]).detach(),
                               norm(x).detach(), atol=1e-5)


# (shape, transposed, vec, cluster, rows a CTA, CTAs): chip_smoke phase 17's
# UNet GroupNorm inputs (CFG batch 16 at 512^2, and batch 3), its case of
# rows that are not 16-byte aligned, and the card tests' ragged shapes
PLAN_SITES = [
    ((16, 64, 64, 320), False, 8, 7, 586, 560), ((16, 64, 64, 320), True, 8, 7, 586, 560),
    ((16, 32, 32, 640), False, 8, 4, 256, 640), ((16, 16, 16, 1280), True, 8, 1, 256, 320),
    ((3, 64, 64, 320), False, 8, 8, 512, 120), ((15, 64, 64, 322), True, 2, 7, 586, 532),
    ((3, 17, 9, 640), True, 8, 2, 77, 60), ((1, 3, 5, 10), False, 2, 1, 15, 1),
    ((3, 7, 5, 34), False, 2, 2, 18, 6),
]


@pytest.mark.parametrize("shape,transposed,vec,cluster,rows,ctas", PLAN_SITES)
def test_stats_plan_at_the_unet_sites(shape, transposed, vec, cluster, rows, ctas):
    """K6's plan (csrc/gn_stats.cu): 16-byte loads where every row is
    16-byte aligned, the slabs of a column block one cluster of at most 8,
    rows split evenly, the sums meeting in distributed shared memory."""
    plan = gn_stats.stats_plan(shape, transposed)
    b, h, w, c = shape
    assert (plan.vec, plan.cluster, plan.rows_per_cta, plan.ctas) == (vec, cluster, rows, ctas)
    assert (plan.planes, plan.cols) == ((1, b * c) if transposed else (b, c))
    assert plan.rows == h * w and plan.scratch == 0 and plan.smem <= 48 * 1024
    assert 1 <= plan.cluster <= gn_stats.MAX_CLUSTER
    assert (plan.cluster - 1) * plan.rows_per_cta < plan.rows <= plan.cluster * plan.rows_per_cta
    assert plan.ctas == plan.cluster * -(-plan.cols // plan.cols_per_cta) * plan.planes
    assert plan.waves == plan.ctas / (gn_stats.SMS * gn_stats.CTAS_PER_SM)
    # a first element that is not 16-byte aligned takes the 4-byte loads
    assert gn_stats.stats_plan(shape, transposed, base_aligned=False).vec == 2


def test_stats_plan_refuses_what_the_kernel_does_not_take():
    for shape in [(2, 4, 4, 9), (0, 4, 4, 8), (2, 0, 4, 8)]:
        with pytest.raises(ValueError, match="C even"):
            gn_stats.stats_plan(shape)
