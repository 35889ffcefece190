"""The gathered-tile Winograd kernel (K3) and its MDT_WINO_TUNE route
against the JAX package.

* `conv3x3_winograd_gathered` (on the CPU: its plain version, the host
  prologue and gather plus `winograd_tiles_plain`) against the JAX
  `conv3x3_winograd(..., dma=False, interpret=True)`, which runs the Pallas
  kernel `_wino_kernel` in interpret mode: with and without the GN+SiLU
  prologue, on one row tile and on several with bottom padding. fp32, 1e-4
  abs, as the K2 test (tests/test_torch_ops.py).
* The tile array against the JAX gather (`_conv3x3_winograd_jit`,
  :405-409) written out in numpy.
* `utils/flags.py` against the JAX package's MDT_WINO_TUNE grammar, and the
  route: `MDT_WINO_TUNE=dma=0` sends the gated sites of a UNet to K3.
The CUDA kernel itself is tested in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.ops.winograd import conv3x3_winograd as jax_winograd
from minddiffusion_tpu.utils import flags as jax_flags
from minddiffusion_tpu_torch import ops
from minddiffusion_tpu_torch.cli.common import tiny_configs
from minddiffusion_tpu_torch.models.layers import conv3x3_dispatch
from minddiffusion_tpu_torch.ops import winograd
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels
from minddiffusion_tpu_torch.utils import flags

ATOL = 1e-4


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("b,h,w,block_rows", [(2, 16, 12, 32), (1, 14, 10, 6)])
def test_gathered_plain_matches_pallas_gather_path(b, h, w, block_rows, gn):
    """(16, 12) is one tile; (14, 10) in 6-row tiles is three, the last
    with 4 rows of bottom padding."""
    rng = np.random.default_rng(h + gn)
    x = rand(rng, b, h, w, 16)
    kern = rand(rng, 3, 3, 16, 24, scale=0.1)
    bias = rand(rng, 24, scale=0.1)
    mult = (1.0 + rand(rng, b, 16, scale=0.1)) if gn else None
    add = rand(rng, b, 16, scale=0.1) if gn else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = jax_winograd(j(x), j(kern), j(bias), gn_mult=j(mult), gn_add=j(add),
                       block_rows=block_rows, interpret=True, dma=False)
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    u = winograd.transform_weights(torch.from_numpy(kern))
    before = winograd.conv3x3_winograd_gathered.launches
    got = winograd.conv3x3_winograd_gathered(tt(x), u, tt(bias), tt(mult), tt(add),
                                             block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert winograd.conv3x3_winograd_gathered.launches == before   # CPU: no kernel


def test_tile_array_is_the_jax_gather():
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 14, 10, 8)
    tiles = winograd.gather_tiles(torch.from_numpy(x), block_rows=6).numpy()
    bh, pad_h = 6, 4                                   # 14 rows -> 3 tiles of 6
    wcols = (10 + 4) // 2
    xp = np.pad(x, ((0, 0), (1, 1 + pad_h), (1, 2 * wcols - 10 - 1), (0, 0)))
    rows = np.arange(3)[:, None] * bh + np.arange(bh + 2)[None, :]
    np.testing.assert_array_equal(tiles, xp[:, rows])
    assert tiles.shape == (2, 3, 8, 14, 8)


@pytest.mark.parametrize("raw", ["", "dma=0", " hmax=64 , cmin=320 ", "chain=0,dma=1",
                                 "dma", "bogus=1", "hmax=x", ",,"])
def test_wino_tune_grammar_is_the_jax_packages(raw):
    try:
        ref = jax_flags._parse_wino_tune(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            flags.parse_wino_tune(raw)
        assert str(got.value) == str(e)
        return
    assert flags.parse_wino_tune(raw) == ref


def test_flags_follow_the_environment_and_feed_the_gate(monkeypatch):
    monkeypatch.delenv("MDT_WINO_TUNE", raising=False)
    assert flags.flags().wino_dma and winograd.wino_route(32, 32, 640)
    assert not winograd.wino_route(64, 64, 640) and not winograd.wino_route(32, 32, 320)
    monkeypatch.setenv("MDT_WINO_TUNE", "hmax=64,cmin=320,dma=0,chain=0")
    f = flags.flags()
    assert (f.wino_dma, f.wino_chain, f.wino_hmax, f.wino_cmin) == (False, False, 64, 320)
    assert winograd.wino_route(64, 64, 640) and winograd.wino_route(32, 32, 320)
    monkeypatch.setenv("MDT_WINO_TUNE", "dma=0,oops")
    with pytest.raises(ValueError, match="MDT_WINO_TUNE entry"):
        flags.flags()


def test_dma_off_routes_the_unet_convs_to_the_gathered_kernel(monkeypatch):
    """Under MDT_WINO_TUNE=dma=0 every gated conv of a UNet eval calls K3's
    wrapper (K2's none), and the eps agrees with the default route; under
    plain_reference() the route runs K3's plain version."""
    monkeypatch.setattr(winograd, "MIN_C_IN", 32)
    pm = SDModels.create(family="wukong", dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(8),
                         **tiny_configs("wukong"))
    calls = {"k2": 0, "k3": 0, "k3_plain": 0}
    for name, key in (("conv3x3_winograd", "k2"), ("conv3x3_winograd_gathered", "k3"),
                      ("winograd_gathered_plain", "k3_plain")):
        real = getattr(winograd, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(winograd, name, spy)
    rng = np.random.default_rng(1)
    x, ctx = tp.t(rand(rng, 2, 32, 32, 4)), tp.t(rand(rng, 2, 77, 32))
    t = torch.tensor([981, 41])
    with torch.no_grad():
        ref = pm.unet(x, t, ctx)
        per_eval = calls["k2"]
        monkeypatch.setenv("MDT_WINO_TUNE", "dma=0")
        got = pm.unet(x, t, ctx)
        with ops.plain_reference():
            plain = pm.unet(x, t, ctx)
    assert per_eval > 0 and calls == {"k2": per_eval, "k3": per_eval, "k3_plain": 2 * per_eval}
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(plain, got, atol=0, rtol=0)
    xs = torch.from_numpy(rand(rng, 1, 16, 16, 32))
    weight = torch.from_numpy(rand(rng, 8, 32, 3, 3, scale=0.1))
    torch.testing.assert_close(conv3x3_dispatch(xs, weight, torch.zeros(8)),
                               torch.nn.functional.conv2d(
                                   xs.permute(0, 3, 1, 2), weight, padding=1
                               ).permute(0, 2, 3, 1), atol=1e-5, rtol=0)
