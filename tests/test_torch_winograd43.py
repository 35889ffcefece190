"""K8 in the port (ops/winograd43.py) against benchmarks/research/winograd43.py:
the plain F(4x4, 3x3) against `conv3x3_winograd43` in interpret mode on the
CPU, fp32 on both sides (H not a multiple of `block_rows`, C_in not a
multiple of 128, a hoisted `u`); `transform_weights43`; `wino43_wins` over a
grid of shapes and under MDT_WINO43=0; and the gradient of
`conv3x3_winograd43_ad` against `jax.vjp` of the JAX package's
`_direct_ref`, which is what the JAX `custom_vjp` differentiates.
Tolerance: 1e-5 of max |reference| (fp32, the same math in another
summation order).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.research import winograd43 as jax_w43
from minddiffusion_tpu.ops.winograd import _direct_ref
from minddiffusion_tpu_torch.ops import winograd43

TOL = 1e-5


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def assert_rel(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


# (B, H, W, C_in, C_out, block_rows): H 12 over 8-row blocks pads 4 rows,
# C_in 24 / 40 pad to 128 lanes, 16x16x128 is lane-aligned
@pytest.mark.parametrize("shape", [(2, 12, 8, 24, 40, 8), (1, 16, 16, 128, 128, 8),
                                   (2, 8, 12, 40, 16, 4)])
def test_plain_matches_pallas(shape):
    *dims, block_rows = shape
    b, h, w, ci, co = dims
    rng = np.random.default_rng(h * w + ci)
    x, k, bias = rand(rng, b, h, w, ci), rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5), \
        rand(rng, co, scale=0.1)
    ref = jax_w43.conv3x3_winograd43(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                     block_rows=block_rows, interpret=True)
    got = winograd43.conv3x3_winograd43(torch.from_numpy(x), torch.from_numpy(k),
                                        torch.from_numpy(bias))
    assert got.shape == ref.shape
    assert_rel(got.numpy(), ref)
    # the hoisted transform gives the same result
    u = winograd43.transform_weights43(torch.from_numpy(k))
    assert_rel(u.numpy(), jax_w43.transform_weights43(jnp.asarray(k)))
    hoisted = winograd43.conv3x3_winograd43(torch.from_numpy(x), torch.from_numpy(k),
                                            torch.from_numpy(bias), u=u)
    assert torch.equal(hoisted, got)


def test_plain_matches_the_direct_conv():
    rng = np.random.default_rng(5)
    x, k, bias = rand(rng, 1, 8, 8, 16), rand(rng, 3, 3, 16, 8, scale=0.1), rand(rng, 8)
    got = winograd43.conv3x3_winograd43(torch.from_numpy(x), torch.from_numpy(k),
                                        torch.from_numpy(bias))
    ref = _direct_ref(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    assert_rel(got.numpy(), ref, 1e-5)


def test_wins_decides_as_jax(monkeypatch):
    grid = itertools.product((64, 128, 130, 256, 512), (128, 132, 256),
                             (96, 128, 256, 512, 1280), (128, 256, 320, 1280))
    for h, w, ci, co in grid:
        assert winograd43.wino43_wins(h, w, ci, co) == jax_w43.wino43_wins(h, w, ci, co), \
            (h, w, ci, co)
    monkeypatch.setenv("MDT_WINO43", "0")
    assert not winograd43.wino43_wins(256, 256, 256, 256)
    assert not jax_w43.wino43_wins(256, 256, 256, 256)


def test_backward_matches_the_jax_vjp_of_the_direct_conv():
    rng = np.random.default_rng(7)
    x, k, bias = rand(rng, 2, 8, 8, 16), rand(rng, 3, 3, 16, 24, scale=0.1), rand(rng, 24)
    g = rand(rng, 2, 8, 8, 24)
    _, vjp = jax.vjp(_direct_ref, jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias)]
    y = winograd43.conv3x3_winograd43_ad(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape
        assert_rel(got.numpy(), ref)
