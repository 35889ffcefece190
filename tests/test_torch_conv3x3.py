"""K7 in the port (ops/conv3x3.py) against benchmarks/research/conv3x3.py:
the plain versions of `conv3x3_pallas` (v1) and `conv3x3_gemm` (v2) against
the Pallas kernels in interpret mode on the CPU, fp32 on both sides, and
`groupnorm_affine_fold` against the JAX one. Cases cover H not a multiple
of `block_rows` (the JAX row padding), C_in not a multiple of 128 (its lane
padding), the GN-affine + SiLU prologue, the residual and fp32 output.
Tolerance: 1e-5 of max |reference| (the same fp32 products summed in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.research import conv3x3 as jax_conv
from minddiffusion_tpu_torch.ops import conv3x3

TOL = 1e-5


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def assert_rel(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


def operands(seed, b, h, w, ci, co):
    rng = np.random.default_rng(seed)
    return (rand(rng, b, h, w, ci), rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5),
            rand(rng, co, scale=0.1), rng)


# (B, H, W, C_in, C_out, block_rows): H 12 over 8-row blocks pads 4 rows;
# C_in 24 and 40 pad to 128 lanes; 16x16x128 is one aligned block
SHAPES = [(2, 12, 8, 24, 40, 8), (1, 16, 16, 128, 128, 32), (2, 10, 6, 40, 16, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_v1_plain_matches_pallas(shape):
    *dims, block_rows = shape
    x, k, bias, _ = operands(1, *dims)
    ref = jax_conv.conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                  block_rows=block_rows, interpret=True)
    got = conv3x3.conv3x3_pallas(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias))
    assert got.shape == ref.shape
    assert_rel(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("form", ["plain", "gn_silu_residual", "silu_fp32_out"])
def test_v2_plain_matches_pallas(shape, form):
    *dims, block_rows = shape
    b, h, w, ci, co = dims
    x, k, bias, rng = operands(2, *dims)
    kw, pkw = {}, {}
    if form == "gn_silu_residual":
        gamma, beta = 1.0 + rand(rng, ci, scale=0.1), rand(rng, ci, scale=0.1)
        a, s = jax_conv.groupnorm_affine_fold(jnp.asarray(x), jnp.asarray(gamma),
                                              jnp.asarray(beta), num_groups=8)
        pa, ps = conv3x3.groupnorm_affine_fold(torch.from_numpy(x), torch.from_numpy(gamma),
                                               torch.from_numpy(beta), num_groups=8)
        assert_rel(pa.numpy(), a)
        assert_rel(ps.numpy(), s)
        res = rand(rng, b, h, w, co)
        kw = dict(prologue_scale=a, prologue_shift=s, silu_prologue=True,
                  residual=jnp.asarray(res))
        pkw = dict(prologue_scale=pa, prologue_shift=ps, silu_prologue=True,
                   residual=torch.from_numpy(res))
    elif form == "silu_fp32_out":
        kw = dict(silu_prologue=True, out_dtype=jnp.float32)
        pkw = dict(silu_prologue=True, out_dtype=torch.float32)
    ref = jax_conv.conv3x3_gemm(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                block_rows=block_rows, interpret=True, **kw)
    got = conv3x3.conv3x3_gemm(torch.from_numpy(x), torch.from_numpy(k),
                               torch.from_numpy(bias), **pkw)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_rel(got.numpy(), ref)


def test_v2_prologue_keeps_the_padding_zero():
    """silu(0 * a + b) != 0: with the prologue, the border outputs equal a
    conv of the transformed image zero-padded afterwards."""
    x, k, bias, rng = operands(3, 1, 6, 6, 8, 8)
    a, s = rand(rng, 1, 8), 1.0 + rand(rng, 1, 8)
    got = conv3x3.conv3x3_gemm(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                               prologue_scale=torch.from_numpy(a),
                               prologue_shift=torch.from_numpy(s), silu_prologue=True)
    xt = torch.nn.functional.silu(torch.from_numpy(x * a[:, None, None] + s[:, None, None]))
    ref = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2),
                                     torch.from_numpy(k).permute(3, 2, 0, 1),
                                     torch.from_numpy(bias), padding=1).permute(0, 2, 3, 1)
    assert_rel(got.numpy(), ref.numpy())


def test_wrappers_refuse_unpaired_prologue():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gemm(x, torch.zeros(3, 3, 8, 8), prologue_scale=torch.ones(1, 8))
