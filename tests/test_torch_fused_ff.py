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
