"""K10 (benchmarks/research/attn_variants.py) and K11
(benchmarks/bench_attention.py `ones_attention`): the port's plain versions
against the Pallas kernels run on the CPU (`interpret=True`; K11, which has
no such argument, under `force_tpu_interpret_mode`), in fp32 on the same
seeded numpy inputs. The same fp32 products are summed in another order, so
each case holds within 1e-5 of max |reference|. On the CPU the wrappers run
the plain versions, so the wrappers are what is called here; the CUDA
kernels are held against the same plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks import bench_attention
from benchmarks.research import attn_variants as jax_av
from minddiffusion_tpu_torch.ops import attn_variants as av

TOL = 1e-5
C, HEADS = 128, 2          # D = 64, the one head dim K10b takes
SCALE = (C // HEADS) ** -0.5
SHAPES = [  # (B, Nq, Nk, block_q): self, ragged Nq (padded q) with Nk 77, Nk = Nq + 128
    (2, 40, 40, 256), (1, 40, 77, 16), (1, 24, 152, 16)]


def _inputs(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape and err <= TOL, err


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("variant", ["ones", "fold"])
@pytest.mark.parametrize("b,nq,nk,block_q", SHAPES)
def test_ones_fold_match_pallas(variant, b, nq, nk, block_q, exact):
    q, k, v = _inputs(nq + nk, (b, nq, C), (b, nk, C), (b, nk, C))
    jax_fn = {"ones": jax_av.flash_attention_packed_ones,
              "fold": jax_av.flash_attention_packed_fold}[variant]
    port_fn = {"ones": av.flash_attention_packed_ones,
               "fold": av.flash_attention_packed_fold}[variant]
    ref = jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE, heads=HEADS,
                 block_q=block_q, exact=exact, interpret=True)
    got = port_fn(*map(torch.from_numpy, (q, k, v)), SCALE, HEADS, exact=exact)
    _close(got, ref)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,block_q,c_out", [
    (2, 40, 40, 256, C), (1, 40, 77, 16, 96), (1, 24, 152, 16, C)])
def test_out_matches_pallas(b, nq, nk, block_q, c_out, exact):
    q, k, v, wo, bo = _inputs(nq + nk + c_out, (b, nq, C), (b, nk, C), (b, nk, C),
                              (C, c_out), (c_out,))
    wo *= C ** -0.5
    ref = jax_av.flash_attention_packed_out(
        *map(jnp.asarray, (q, k, v, wo, bo)), scale=SCALE, heads=HEADS, block_q=block_q,
        exact=exact, interpret=True)
    got = av.flash_attention_packed_out(*map(torch.from_numpy, (q, k, v, wo, bo)), SCALE,
                                        HEADS, exact=exact)
    _close(got, ref)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,n,block_q", [(2, 32, 16), (1, 24, 256)])
def test_proj_matches_pallas(b, n, block_q, exact):
    x, wq, wk, wv, wo, bo = _inputs(n + b, (b, n, C), *[(C, C)] * 4, (C,))
    wq, wk, wv, wo = (w * C ** -0.5 for w in (wq, wk, wv, wo))
    ref = jax_av.flash_attention_packed_proj(
        *map(jnp.asarray, (x, wq, wk, wv, wo, bo)), scale=SCALE, heads=HEADS,
        block_q=block_q, exact=exact, interpret=True)
    got = av.flash_attention_packed_proj(*map(torch.from_numpy, (x, wq, wk, wv, wo, bo)),
                                         SCALE, HEADS, block_q=block_q, exact=exact)
    _close(got, ref)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,block_q", [(2, 40, 40, 16), (1, 40, 77, 256)])
def test_ones_attention_matches_pallas(b, nq, nk, block_q, exact):
    """K11 with an unpadded ragged last q block (40 = 2 x 16 + 8)."""
    q, k, v = _inputs(3 * nq + nk, (b, nq, C), (b, nk, C), (b, nk, C))
    with pltpu.force_tpu_interpret_mode():
        ref = bench_attention.ones_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             SCALE, HEADS, block_q=block_q, exact=exact)
    got = av.ones_attention(*map(torch.from_numpy, (q, k, v)), SCALE, HEADS, exact=exact)
    _close(got, ref)


def test_ones_and_fold_agree_with_each_other_and_k11():
    """K10a, K10b and K11 compute one function on the CPU (bitwise)."""
    q, k, v = map(torch.from_numpy, _inputs(5, (1, 33, C), (1, 70, C), (1, 70, C)))
    a = av.flash_attention_packed_ones(q, k, v, SCALE, HEADS)
    assert torch.equal(a, av.flash_attention_packed_fold(q, k, v, SCALE, HEADS))
    assert torch.equal(a, av.ones_attention(q, k, v, SCALE, HEADS))


def test_augment_v_layout():
    v = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    va = av.augment_v(v, heads=2).reshape(2, 3, 2, 8)
    assert torch.equal(va[..., :4], v.reshape(2, 3, 2, 4))
    assert torch.equal(va[..., 4], torch.ones(2, 3, 2))
    assert not va[..., 5:].any()


def test_refusals():
    """The JAX functions' asserts as ValueError: K10b at D != 64, K10c with
    N % block_q != 0. CPU tensors never reach a kernel."""
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="head_dim 64"):
        av.flash_attention_packed_fold(q, q, q, 0.25, heads=2)
    x = torch.zeros(1, 40, C)
    w = torch.zeros(C, C)
    with pytest.raises(ValueError, match="block_q"):
        av.flash_attention_packed_proj(x, w, w, w, w, torch.zeros(C), SCALE, HEADS,
                                       block_q=16)
    counts = [fn.launches for fn in (av.flash_attention_packed_ones, av.ones_attention,
                                     av.flash_attention_packed_fold,
                                     av.flash_attention_packed_out,
                                     av.flash_attention_packed_proj)]
    assert counts == [0] * 5
