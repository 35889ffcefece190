"""The head-split attention kernel (K4) and the attention route of the port
against the JAX package.

* `flash_attention_plain` (K4's plain version) against the JAX
  `flash_attention` run in interpret mode on the CPU, as the JAX package's own
  tests run it: D 64 and 512, both softmax modes, ragged Nq / Nk, small JAX
  blocks so its online (multi-k-block) path runs. fp32, 1e-5 abs.
* The route: at every attention site of the SD2 UNet and VAE at 512², 768²
  and 768x1024, the port's `packed_attention` picks the same kernel in the
  same softmax mode as the JAX route with its TPU dispatch switched on. The
  JAX side runs under `jax.eval_shape` with recorders in place of its kernel
  entries; the port runs on meta tensors with recorders in place of its
  kernel wrappers. Nothing in the JAX package changes.
The CUDA kernel itself is tested against the plain version in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddiffusion_tpu.ops import attention as jax_attention
from minddiffusion_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from minddiffusion_tpu_torch.ops import attention, flash_attention

ATOL = 1e-5


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,heads,d,block_q,block_k", [
    (1, 300, 640, 2, 64, 128, 256),     # 5 k blocks of 128, q padded to 384
    (2, 77, 77, 1, 64, 512, 4096),      # one k block, Nk not a multiple of 128
    (1, 200, 384, 1, 512, 128, 128),    # the VAE head width, 3 k blocks
])
def test_flash_attention_plain_matches_pallas(b, nq, nk, heads, d, block_q, block_k,
                                              exact):
    rng = np.random.default_rng(nq + nk + d)
    q, k, v = rand(rng, b, nq, heads, d), rand(rng, b, nk, heads, d), rand(rng, b, nk, heads, d)
    scale = d ** -0.5
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                              block_q=block_q, block_k=block_k, exact_softmax=exact,
                              interpret=True)
    got = flash_attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale, exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_attention_modes_agree_below_the_shift_overflow():
    """exp(s - 20) and the online max give the same softmax while the logits
    stay below 20 + 88; the plain version launches nothing on the CPU."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rand(rng, 1, 130, 2, 64)) for _ in range(3))
    before = flash_attention.flash_attention.launches
    exact = flash_attention.flash_attention(q, k, v, 0.125, True)
    shifted = flash_attention.flash_attention(q, k, v, 0.125, False)
    torch.testing.assert_close(shifted, exact, atol=1e-5, rtol=0)
    assert flash_attention.flash_attention.launches == before


# ---- the route at the SD2 sites ---------------------------------------------

def sd2_sites(height: int, width: int):
    """(label, nq, nk, C, heads, impl-follows-caller) of every attention site
    of the SD2 UNet (ch 320, mult 1,2,4,4, attention at ds 1, 2, 4, head_dim
    64, 77 text tokens) and of the VAE mid blocks (C 512, one head)."""
    h8, w8 = height // 8, width // 8
    sites = []
    for ds, mult in ((1, 1), (2, 2), (4, 4), (8, 4)):
        n, c = (h8 // ds) * (w8 // ds), 320 * mult
        sites += [(f"unet ds{ds} self", n, n, c, c // 64, True),
                  (f"unet ds{ds} cross", n, 77, c, c // 64, True)]
    sites.append(("vae mid", h8 * w8, h8 * w8, 512, 1, False))
    return sites


SIZES = [(512, 512), (768, 768), (768, 1024)]
PORT_TO_JAX_IMPL = {None: None, "fast": "pallas_fast"}


def jax_route(monkeypatch, nq, nk, c, heads, impl):
    calls = []

    def packed(q, k, v, scale, heads_, block_q, exact):
        calls.append(("packed", exact))
        return q

    def flash(q, k, v, scale):
        calls.append(("flash", True))
        return q

    monkeypatch.setattr(jax_attention, "_pallas_available", lambda: True)
    monkeypatch.setattr(jax_attention, "_packed_ad", packed)
    monkeypatch.setattr(jax_attention, "_flash_ad", flash)
    q = jax.ShapeDtypeStruct((1, nq, c), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((1, nk, c), jnp.bfloat16)
    jax.eval_shape(lambda a, b_: jax_attention.packed_attention(
        a, b_, b_, heads, impl=PORT_TO_JAX_IMPL[impl]), q, kv)
    return calls[0] if calls else ("einsum", None)


def port_route(monkeypatch, nq, nk, c, heads, impl):
    calls = []

    def packed(q, k, v, heads_, scale, exact=True):
        calls.append(("packed", exact))
        return torch.empty_like(q)

    def flash(q, k, v, scale, exact_softmax=True):
        calls.append(("flash", exact_softmax))
        return torch.empty_like(q)

    monkeypatch.setattr(flash_attention, "flash_attention_packed", packed)
    monkeypatch.setattr(flash_attention, "flash_attention", flash)
    q = torch.empty(1, nq, c, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, nk, c, device="meta", dtype=torch.bfloat16)
    out = attention.packed_attention(q, kv, kv, heads, impl=impl)
    assert out.shape == q.shape
    return calls[0] if calls else ("einsum", None)


@pytest.mark.parametrize("impl", [None, "fast"])
@pytest.mark.parametrize("height,width", SIZES)
def test_route_picks_the_jax_kernel_and_mode_at_every_sd2_site(monkeypatch, height,
                                                               width, impl):
    for label, nq, nk, c, heads, follows in sd2_sites(height, width):
        site_impl = impl if follows else None
        ref = jax_route(monkeypatch, nq, nk, c, heads, site_impl)
        got = port_route(monkeypatch, nq, nk, c, heads, site_impl)
        assert got == ref, (height, width, label, site_impl, got, ref)


def test_route_table_of_the_long_sites():
    """The kernel of each long site, as worked out from the footprint rule:
    K4 takes the VAE mid attention at 768² and up and the UNet ds1
    self-attention at 768x1024; K1 takes the rest of the long sites."""
    def kernel(nq, nk, c):
        return "K1" if attention.packed_route(nq, nk, c) else "K4"
    assert kernel(4096, 4096, 320) == kernel(1024, 1024, 640) == "K1"
    assert kernel(4096, 4096, 512) == "K1"                 # 512² VAE mid
    assert kernel(9216, 9216, 320) == kernel(2304, 2304, 640) == "K1"
    assert kernel(9216, 9216, 512) == "K4"                 # 768² VAE mid
    assert kernel(12288, 12288, 320) == "K4"               # 768x1024 UNet ds1
    assert kernel(3072, 3072, 640) == "K1"
    assert kernel(12288, 12288, 512) == "K4"               # 768x1024 VAE mid
    assert not attention.packed_route(1024, 1000, 320)     # nk % 128


def test_dot_product_attention_gates():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rand(rng, 1, 1024, 2, 16))
    kv = torch.from_numpy(rand(rng, 1, 600, 2, 16))
    ein = attention.einsum_attention(q, kv, kv)
    torch.testing.assert_close(attention.dot_product_attention(q, kv, kv), ein,
                               atol=1e-5, rtol=0)
    bias = torch.zeros(1, 1, 1024, 600)
    torch.testing.assert_close(attention.dot_product_attention(q, kv, kv, bias=bias),
                               ein, atol=1e-6, rtol=0)
