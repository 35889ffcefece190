"""Port kernels' plain versions vs the JAX package's Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as the
JAX package's own tests do. Inputs are seeded numpy, compared in fp32 with
an absolute tolerance of 1e-4. The CUDA kernels themselves are tested in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

from minddiffusion_tpu.models.layers import gn_affine_from_sums as jax_gn_affine
from minddiffusion_tpu.models.layers import timestep_embedding as jax_timestep_embedding
from minddiffusion_tpu.ops.attention import einsum_attention as jax_einsum_attention
from minddiffusion_tpu.ops.flash_attention import flash_attention_packed as jax_packed
from minddiffusion_tpu.ops.winograd import conv3x3_winograd as jax_winograd
from minddiffusion_tpu.ops.winograd import transform_weights as jax_transform
from minddiffusion_tpu_torch.models.layers import gn_affine_from_sums, timestep_embedding
from minddiffusion_tpu_torch.ops import attention, attn_diag, attn_variants, flash_attention, winograd

ATOL = 1e-4


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("nq", [1024, 300])
@pytest.mark.parametrize("heads,c", [(2, 128), (1, 128)])
def test_packed_attention_plain_matches_pallas(nq, heads, c, exact):
    rng = np.random.default_rng(nq + heads)
    q, k, v = rand(rng, 2, nq, c), rand(rng, 2, 1024, c), rand(rng, 2, 1024, c)
    scale = (c // heads) ** -0.5
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, heads,
                     exact=exact, interpret=True)
    got = flash_attention.packed_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads, scale, exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_packed_attention_routes_by_the_token_gates():
    rng = np.random.default_rng(0)
    q, kv = torch.from_numpy(rand(rng, 1, 1024, 64)), torch.from_numpy(rand(rng, 1, 512, 64))
    ein = attention.einsum_attention(q.reshape(1, 1024, 4, 16), kv.reshape(1, 512, 4, 16),
                                     kv.reshape(1, 512, 4, 16)).reshape(1, 1024, 64)
    before = flash_attention.flash_attention_packed.launches
    for impl in (None, "fast"):
        got = attention.packed_attention(q, kv, kv, 4, impl=impl)
        torch.testing.assert_close(got, ein, atol=1e-5, rtol=0)
    # short keys (cross-attention) never reach the kernel wrapper
    short = kv[:, :77]
    got = attention.packed_attention(q, short, short, 4)
    assert got.shape == q.shape
    # a long site the footprint rule turns away (6400 keys x C 512 > 12 MiB)
    # goes to the head-split kernel in exact mode, also under "fast": with
    # logits far above 88 the raw-exp softmax would overflow, exact does not
    wide_q = torch.from_numpy(rand(rng, 1, 1024, 512, scale=30.0))
    wide_kv = torch.from_numpy(rand(rng, 1, 6400, 512))
    assert not attention.packed_route(1024, 6400, 512)
    assert (wide_q[0] @ wide_kv[0].T).max() * 512 ** -0.5 > 88
    heads_split = [t[:, :, None] for t in (wide_q, wide_kv, wide_kv)]
    ref = flash_attention.flash_attention_plain(*heads_split, 512 ** -0.5, True)[:, :, 0]
    raw = flash_attention.packed_attention_plain(wide_q, wide_kv, wide_kv, 1,
                                                 512 ** -0.5, exact=False)
    assert torch.isfinite(ref).all() and not torch.isfinite(raw).all()
    for impl in (None, "fast"):
        got = attention.packed_attention(wide_q, wide_kv, wide_kv, 1, impl=impl)
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    # on the CPU the wrappers run their plain versions and launch nothing
    assert flash_attention.flash_attention_packed.launches == before
    assert flash_attention.flash_attention.launches == 0


@pytest.mark.parametrize("b,nq,c,heads,plan", [
    (16, 4096, 320, 5, (192, 64, 6, 1)),   # SD2 ds1: K10d's 192-row tier
    (16, 1024, 640, 10, (128, 64, 4, 1)),  # SD2 ds2
    (8, 4096, 512, 1, (64, 64, 1, 1)),     # the VAE mid: its own D 512 kernel
    (8, 4096, 320, 8, (128, 64, 8, 1)),    # SD1 ds1, D 40: 128 rows beat 192 there
    (8, 1024, 640, 8, (128, 64, 4, 2)),    # SD1 ds2, D 80: 64 CTAs -> two groups of 4 heads
    (8, 1024, 1280, 8, (64, 32, 2, 1)),    # SD1 ds4, D 160: 32-key tiles, 160 KB of q tile
    (16, 1024, 384, 6, (128, 64, 8, 1)),   # GLIDE base ds2
    (8, 1024, 384, 6, (128, 64, 8, 2)),    # GLIDE super-res ds8
    (8, 256, 768, 12, (128, 64, 8, 12)),   # GLIDE's 16^2 tier: a head a CTA
    (1, 1024, 512, 2, None),               # D 512 takes one head
    (1, 1024, 384, 8, None),               # D 48 is no width of the kernel
])
def test_packed_plan_at_the_kernel_sites(b, nq, c, heads, plan):
    """K1's launch plan (rows, keys a tile, stages, head groups) on an H100,
    that its q tile and ring fit a block's shared memory, and that each
    group's columns are whole 64-column boxes."""
    assert flash_attention.packed_plan(nq, c, heads, b) == plan
    if plan is not None and c // heads != 512:
        rows, kt, stages, groups = plan
        d = c // heads
        stage = (-(-(-(-d // 16) * 16) // 64) + -(-d // 64)) * kt * 128
        assert 2 <= stages <= flash_attention.MAX_STAGES
        assert groups == 1 or (c // groups) % 64 == 0
        assert (flash_attention.SMEM_SLACK + -(-c // groups // 64) * rows * 128
                + stages * stage <= flash_attention.SMEM_MAX)
    q = torch.empty(b, nq, c, dtype=torch.bfloat16, device="meta")
    for nk in (1, 77, nq + 128):   # any Nk: the keys past it are TMA's zero fill
        k = torch.empty(b, nk, c, dtype=torch.bfloat16, device="meta")
        assert flash_attention.kernel_supports(q, k, heads) == (plan is not None)


def _core_plan_fits(plan, c: int, stage: int) -> None:
    """A plan of a kernel on the attention core at D 64 fits a block's
    shared memory with at least two stages."""
    rows, stages, groups = plan
    assert 2 <= stages <= flash_attention.MAX_STAGES and rows in (64, 128, 192)
    assert (flash_attention.SMEM_SLACK + c // groups // 64 * rows * 128 + stages * stage
            <= flash_attention.SMEM_MAX)


@pytest.mark.parametrize("mode,b,n,c,heads,plan", [
    ("full", 16, 4096, 320, 5, (192, 6, 1)),        # ds1: K1's plan
    ("qk", 16, 4096, 320, 5, (192, 8, 1)),          # no V read: stages of a K tile
    ("fp32pv", 16, 4096, 320, 5, (128, 6, 1)),      # K and the fp32 V^T tile: 24 KB; 128 rows
    ("exp", 16, 1024, 640, 10, (128, 8, 1)),        # ds2
    ("bf16s", 16, 1024, 640, 10, (128, 4, 1)),
    ("nosm", 16, 256, 1280, 20, (128, 8, 4)),       # ds4: 4 head groups, 128 CTAs
    ("slice", 2, 3200, 704, 11, (64, 8, 1)),        # the 64-row tier
    ("expslice", 2, 2048, 320, 5, (192, 8, 5)),     # 22 CTAs -> 5 groups
])
def test_diag_plan_at_the_ds_sites(mode, b, n, c, heads, plan):
    """K12's launch plan (rows, stages, head groups): K1's at D 64, its
    stages sized for the mode's ring stage."""
    assert attn_diag.diag_plan(mode, b, n, c, heads) == plan
    stage = 8192 * (1 if mode in ("qk", "exp", "slice", "expslice")
                    else 3 if mode == "fp32pv" else 2)
    _core_plan_fits(plan, c, stage)


@pytest.mark.parametrize("b,nq,c,heads,plan", [
    (16, 4096, 320, 5, (192, 4, 1)),     # ds1
    (16, 1024, 640, 10, (128, 2, 1)),    # ds2: the 160 KB q tile leaves two 24 KB stages
    (16, 256, 1280, 20, (128, 6, 4)),    # K11's ds4: 64 CTAs of 64 rows -> 4 head groups
    (2, 3199, 704, 11, (64, 5, 1)),      # the 64-row tier
    (2, 2049, 320, 5, (192, 8, 5)),     # 22 CTAs -> 5 head groups
])
def test_ones_plan_at_the_ds_sites(b, nq, c, heads, plan):
    """The ones kernel's launch plan: K1's at D 64, stages of 24 KB."""
    assert attn_variants.ones_plan(b, nq, c, heads) == plan
    _core_plan_fits(plan, c, attn_variants.ONES_STAGE)


@pytest.mark.parametrize("gn", [True, False])
def test_winograd_plain_matches_pallas(gn):
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 16, 12, 16)
    kern = rand(rng, 3, 3, 16, 24, scale=0.1)
    bias = rand(rng, 24, scale=0.1)
    mult = (1.0 + rand(rng, 2, 16, scale=0.1)) if gn else None
    add = rand(rng, 2, 16, scale=0.1) if gn else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = jax_winograd(j(x), j(kern), j(bias), gn_mult=j(mult), gn_add=j(add),
                       interpret=True, dma=True)
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    u = winograd.transform_weights(torch.from_numpy(kern))
    got = winograd.conv3x3_winograd(tt(x), u, tt(bias), tt(mult), tt(add))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("gn", [True, False])
def test_winograd_plain_matches_conv2d(gn):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rand(rng, 2, 14, 18, 8))
    kern = torch.from_numpy(rand(rng, 3, 3, 8, 12, scale=0.2))
    bias = torch.from_numpy(rand(rng, 12))
    mult = torch.from_numpy(1.0 + rand(rng, 2, 8, scale=0.2)) if gn else None
    add = torch.from_numpy(rand(rng, 2, 8, scale=0.2)) if gn else None
    xin = x
    if gn:
        xin = F.silu(x * mult[:, None, None] + add[:, None, None])
    ref = F.conv2d(xin.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1), bias, padding=1)
    got = winograd.conv3x3_winograd(x, winograd.transform_weights(kern), bias, mult, add)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), atol=ATOL, rtol=0)


def test_transform_weights_matches_jax():
    kern = rand(np.random.default_rng(3), 3, 3, 5, 7)
    np.testing.assert_allclose(winograd.transform_weights(torch.from_numpy(kern)).numpy(),
                               np.asarray(jax_transform(jnp.asarray(kern))), atol=1e-6)


def test_wino_route_is_the_jax_shape_gate_without_vmem_cap():
    assert winograd.wino_route(32, 32, 640) and winograd.wino_route(16, 16, 2560)
    assert not winograd.wino_route(64, 64, 640)       # above 48
    assert not winograd.wino_route(8, 8, 1280)        # below 12
    assert not winograd.wino_route(32, 32, 320)       # C_in < 512
    assert not winograd.wino_route(16, 15, 1280)      # odd width


@pytest.mark.parametrize("with_emb", [False, True])
def test_gn_affine_from_sums_matches_jax(with_emb):
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 6, 6, 64, scale=2.0) + 0.5
    scale, bias = 1.0 + rand(rng, 64, scale=0.1), rand(rng, 64, scale=0.1)
    emb = rand(rng, 2, 64) if with_emb else None
    s1, s2 = x.sum((1, 2)), (x * x).sum((1, 2))
    ref = jax_gn_affine(jnp.asarray(s1), jnp.asarray(s2), 36, jnp.asarray(scale),
                        jnp.asarray(bias), emb=None if emb is None else jnp.asarray(emb))
    got = gn_affine_from_sums(torch.from_numpy(s1), torch.from_numpy(s2), 36,
                              torch.from_numpy(scale), torch.from_numpy(bias),
                              emb=None if emb is None else torch.from_numpy(emb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_einsum_attention_with_causal_bias_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = rand(rng, 2, 7, 4, 8), rand(rng, 2, 7, 4, 8), rand(rng, 2, 7, 4, 8)
    bias = np.triu(np.full((7, 7), -np.inf, np.float32), 1)[None, None]
    ref = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bias=jnp.asarray(bias))
    got = attention.einsum_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_timestep_embedding_matches_jax():
    ts = np.array([1, 500, 981], np.int32)
    for dim in (32, 33):
        ref = jax_timestep_embedding(jnp.asarray(ts), dim)
        got = timestep_embedding(torch.from_numpy(ts), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---- raw-exp validity (the JAX package's logit < 88 condition) -------------

SD2_SELF_ATTN_SITES = [(4096, 320, 5), (1024, 640, 10)]   # (tokens, C, heads)


@settings(max_examples=6, deadline=None)
@given(site=st.sampled_from(SD2_SELF_ATTN_SITES), seed=st.integers(0, 2 ** 16))
def test_raw_exp_valid_at_sd2_sites(site, seed):
    """With q/k projections drawn at the SD scale (N(0, 1/C), inputs the
    unit-variance LayerNorm output), the largest logit stays far below 88,
    and the raw-exp softmax agrees with the exact one to 1e-5."""
    n, c, heads = site
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, n, c, generator=g)
    wq, wk, wv = (torch.randn(c, c, generator=g) * c ** -0.5 for _ in range(3))
    q, k, v = x @ wq, x @ wk, x @ wv
    d = c // heads
    scale = d ** -0.5
    logits = torch.einsum("qhd,khd->hqk", (q[0] * scale).reshape(n, heads, d),
                          k[0].reshape(n, heads, d))
    assert logits.max().item() < 88.0
    exact = flash_attention.packed_attention_plain(q, k, v, heads, scale, exact=True)
    raw = flash_attention.packed_attention_plain(q, k, v, heads, scale, exact=False)
    torch.testing.assert_close(raw, exact, atol=1e-5, rtol=0)


def test_raw_exp_overflows_above_logit_88_while_exact_does_not():
    q = torch.zeros(1, 4, 64)
    q[..., 0] = 100.0
    k = torch.zeros(1, 128, 64)
    k[..., 0] = 8.0                                    # logit 100 * 8 / 8 = 100
    v = torch.randn(1, 128, 64, generator=torch.Generator().manual_seed(0))
    exact = flash_attention.packed_attention_plain(q, k, v, 1, 64 ** -0.5, exact=True)
    raw = flash_attention.packed_attention_plain(q, k, v, 1, 64 ** -0.5, exact=False)
    assert torch.isfinite(exact).all() and not torch.isfinite(raw).all()
