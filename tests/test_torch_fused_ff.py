"""The fused LN -> GEGLU -> FF kernel K5 (`ops/fused_ff.py`): its plain
version against the JAX package's `fused_ln_geglu_ff(force_pallas=True,
interpret=True)` (benchmarks/research/fused_ff.py) in fp32 and bf16, and
against the port's own `x + ff(norm3(x))` of a BasicTransformerBlock.

Tolerances, relative to the largest magnitude of the reference: fp32 1e-5
(the same math in another summation order); bf16 1e-2 (both sides round
the normalised rows and the GEGLU product to bf16, and a value on a
rounding boundary may round the other way after the frameworks' fp32
matmuls differ in the last bit); against the port's block in fp32 1e-5
(the block keeps the LN affine in fp32 and computes the variance as
E[(x - mu)^2]: equal in fp32 up to rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.research import fused_ff as jax_ff
from minddiffusion_tpu_torch.models.attention import BasicTransformerBlock
from minddiffusion_tpu_torch.ops import fused_ff


def params(seed: int, c: int, f: int):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + 0.1 * n(c), ln_b=0.1 * n(c), w1=n(c, 2 * f) * c ** -0.5,
                b1=0.1 * n(2 * f), w2=n(f, c) * f ** -0.5, b2=0.1 * n(c))


def assert_rel(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("b,n,c", [(2, 40, 32), (1, 300, 64)])
def test_plain_matches_pallas_kernel(b, n, c, dtype, tol):
    """n = 300 pads the rows to the 256-row block in the JAX kernel."""
    f = 4 * c
    p = params(0, c, f)
    x = np.random.default_rng(1).standard_normal((b, n, c)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x, jdt)
    ref = jax_ff.fused_ln_geglu_ff(
        xj, jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]), jnp.asarray(p["w1"]),
        jnp.asarray(p["b1"]), jnp.asarray(p["w2"]), jnp.asarray(p["b2"]), eps=1e-5,
        interpret=True, force_pallas=True)
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = fused_ff.fused_ln_geglu_ff(
        t(np.asarray(xj.astype(jnp.float32))).to(tdt), t(p["ln_w"]), t(p["ln_b"]),
        t(p["w1"].T), t(p["b1"]), t(p["w2"].T), t(p["b2"]), eps=1e-5)
    assert got.dtype == tdt and got.shape == (b, n, c)
    assert_rel(got.float(), np.asarray(ref.astype(jnp.float32)), tol)


def test_plain_matches_the_ports_transformer_block():
    torch.manual_seed(0)
    block = BasicTransformerBlock(64, 4, 16, 32)
    with torch.no_grad():
        for prm in block.parameters():
            prm.normal_(0.0, 0.1)
        block.norm3.weight.add_(1.0)
        x = torch.randn(2, 50, 64)
        ref = x + block.ff(block.norm3(x))
        got = fused_ff.fused_ln_geglu_ff(x, *fused_ff.block_args(block))
    assert_rel(got, ref, 1e-5)


def test_forward_only():
    block = BasicTransformerBlock(64, 4, 16, 32)
    x = torch.randn(1, 8, 64)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_ff.fused_ln_geglu_ff(x, *fused_ff.block_args(block))
    with torch.no_grad():
        assert fused_ff.fused_ln_geglu_ff(x, *fused_ff.block_args(block)).shape == x.shape


@pytest.mark.parametrize("m,c,regime,ctas,tiles", [
    (16 * 4096, 320, "F", (512,), (512,)),             # SD2 / Wukong 512^2 ds1
    (16 * 1024, 640, "H", (1056, 132, 132), (2560, 640)),   # ds2
    (16 * 256, 1280, "H", (512, 132, 132), (1280, 320)),    # ds4
    (16 * 64, 1280, "H", (128, 132, 80), (320, 80)),        # the 8^2 mid block
    (77, 320, "F", (2,), (2,)),                        # ragged: one cluster, rows past M
    (1, 320, "F", (2,), (2,)),
    (77, 1280, "H", (10, 40, 10), (40, 10)),            # one row tile: fewer CTAs than SMs
])
def test_ff_plan_at_the_sd_sites(m, c, regime, ctas, tiles):
    """K5's plan (csrc/fused_ff.cu) at the SD2 / Wukong FF sites at CFG batch
    16 and ragged M: regime F (fused, 2-CTA clusters of 128 rows) at C 320,
    H (LN pass, up and down GEMMs on 128-row tiles of 128 U or output
    columns, persistent on the 132 SMs) at C 640 and 1280; every product CTA fits a block's shared memory,
    and the products' flops are 6 M C F exactly (nothing recomputed)."""
    f = 4 * c
    plan = fused_ff.ff_plan(m, c, f)
    assert plan.regime == regime and plan.ctas == ctas
    assert plan.smem <= fused_ff.SMEM_MAX == 232448
    assert plan.flops == 1.0
    assert plan.waves == tuple(t / 132 for t in tiles)
    if regime == "F":
        assert (plan.cluster, plan.launches, plan.rows, plan.fc) == (2, 1, 128, 32)
        assert plan.stages == (14,)
        assert ctas[0] * plan.rows >= m and ctas[0] % plan.cluster == 0
    else:
        assert (plan.cluster, plan.launches, plan.rows, plan.fc) == (1, 3, 128, 128)
        assert plan.stages == (4, 6)
        rows = -(-m // 128)
        assert tiles == (rows * f // 128, rows * c // 128)


def test_ff_plan_refuses_what_the_kernels_do_not_take():
    for m, c, f in [(0, 320, 1280), (8, 64, 256), (8, 96, 384), (8, 320, 1000),
                    (8, 1600, 6400)]:
        with pytest.raises(ValueError, match="C a multiple of 320 up to 1280"):
            fused_ff.ff_plan(m, c, f)
    assert fused_ff.ff_plan(64, 960, 3840).regime == "H"
    assert fused_ff.ff_plan(64, 640, 32 * 81).regime == "H"   # F a multiple of 32 only
