"""K12 (benchmarks/bench_attn_ds1.py's `diag`, `diag_kt`, `diag_slice`,
`diag_bf16s`): the port's plain versions against the Pallas kernels run on
the CPU under `force_tpu_interpret_mode`, on the same seeded numpy inputs.
The script's kernels read their shapes from its module globals, which a
fixture sets to a small shape (B 2, N 256, C 128, 2 heads of 64, q blocks
of 128) and restores afterwards. In fp32 the same products are summed in
another order, so each mode holds within 1e-5 of max |reference|; bf16s in
bf16 within 1e-2 (its scores are rounded to bf16 before the exp, and the
two frameworks round its products' sums at other places). On the CPU the
wrappers take the plain versions, so the wrappers are what is called; the
CUDA kernels are held against the same plain versions in test_torch_cuda.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from minddiffusion_tpu_torch.bench import attn_ds1
from minddiffusion_tpu_torch.ops import attn_diag as ad

SHAPE = {"B": 2, "N": 256, "C": 128, "H": 2, "D": 64}
BQ = 128
TOL, TOL_BF16 = 1e-5, 1e-2


@pytest.fixture(scope="module")
def script():
    """The JAX script at SHAPE. Importing it points JAX's compilation cache
    at a fixed directory (its line 20); the setting in force before the
    import is put back at once."""
    cache_dir = jax.config.jax_compilation_cache_dir
    script = importlib.import_module("benchmarks.bench_attn_ds1")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    saved = {k: getattr(script, k) for k in SHAPE}
    for k, v in SHAPE.items():
        setattr(script, k, v)
    yield script
    for k, v in saved.items():
        setattr(script, k, v)
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def jax_variant(script, name: str):
    mode = name[len("diag_"):]
    if mode.startswith("kt_"):
        return script.diag_kt(mode[3:], bq=BQ)
    if mode in ("qk_slice", "qkexp_slice"):
        return script.diag_slice("slice" if mode == "qk_slice" else "expslice", bq=BQ)
    if mode in ("bf16s", "bf16s_ex2"):   # the packed exp is the card's; the function is one
        return script.diag_bf16s(bq=BQ)
    return script.diag(mode, bq=BQ)


def inputs(seed: int, scale: float = 0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((SHAPE["B"], SHAPE["N"], SHAPE["C"])) * scale)
            .astype(np.float32) for _ in range(3)]


def run_jax(script, name, arrays, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_variant(script, name)(*(jnp.asarray(a, dtype) for a in arrays))
    return np.asarray(out.astype(jnp.float32))


def test_the_port_has_every_diag_variant_of_the_script(script):
    assert set(ad.variants()) == ({k for k in script.VARIANTS if k.startswith("diag_")}
                                  | {"diag_bf16s_ex2"})


@pytest.mark.parametrize("name", list(ad.variants()))
def test_diag_plain_matches_pallas(script, name):
    arrays = inputs(1)
    ref = run_jax(script, name, arrays)
    fn, _ = ad.variants()[name]
    got = fn(*map(torch.from_numpy, arrays), SHAPE["H"]).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_diag_bf16s_matches_pallas_in_bf16(script):
    arrays = inputs(2)
    ref = run_jax(script, "diag_bf16s", arrays, jnp.bfloat16)
    got = ad.diag_bf16s(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays), SHAPE["H"])
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= TOL_BF16 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["diag_exp", "diag_fp32pv", "diag_full", "diag_bf16s",
                                  "diag_qkexp_slice"])
def test_diag_overflows_where_pallas_does(script, name):
    """No scale, no max: with q = k = v and row 5 scaled so that its
    diagonal logit (~150) passes 88, the same outputs are inf or NaN."""
    x = inputs(3)[0]
    x[:, 5] *= 3.0
    ref = run_jax(script, name, [x, x, x])
    fn, _ = ad.variants()[name]
    got = fn(*(torch.from_numpy(x),) * 3, SHAPE["H"]).numpy()
    assert not np.isfinite(ref).all()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= TOL * np.abs(ref[fin]).max()


def test_plain_score_scale_moves_the_scores():
    q, k, v = map(torch.from_numpy, inputs(4))
    base = ad.diag_plain(q, k, v, 2, "qk")
    assert torch.allclose(ad.diag_plain(q, k, v, 2, "qk", score_scale=2.0), 2 * base,
                          rtol=1e-5, atol=1e-5)


def test_exp_rounded_reads_an_exp_table_by_bf16_bits():
    """A table of torch.exp at every bf16 input gives torch.exp's values,
    and diag_bf16s's plain version with it is the one without it."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    table = torch.exp(bits.view(torch.bfloat16))
    s = torch.randn(64, 64) * 30
    torch.testing.assert_close(ad.exp_rounded(s, torch.bfloat16, table),
                               ad.exp_rounded(s, torch.bfloat16), rtol=0, atol=0,
                               equal_nan=True)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in inputs(5))
    torch.testing.assert_close(ad.diag_bf16s_plain(q, k, v, 2, exp_table=table),
                               ad.diag_bf16s_plain(q, k, v, 2), rtol=0, atol=0)
    with pytest.raises(TypeError, match="bf16 bits"):
        ad.exp_rounded(s, torch.float32, table)


@pytest.mark.parametrize("name", ["diag_exp", "diag_fp32pv", "diag_qkexp_slice"])
def test_hold_scale_sees_every_row_of_the_raw_exp_modes(name):
    """The raw exp outputs are held row by row (or output by output): 5% off
    in every other row (but the rows near the largest output) breaks 2e-2
    of `hold_scale`, where 2e-2 of max |ref| over the tensor lets it
    through."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in inputs(6, scale=1.0))
    fn, _ = ad.variants()[name]
    ref = fn(q, k, v, 2).float()
    off = torch.zeros(ref.shape[:2], dtype=torch.bool)
    off[:, 1::2] = True
    off &= ref.abs().amax(-1) < 0.1 * ref.abs().max()
    assert off.sum() > ref.shape[1] // 4
    err = torch.where(off[..., None], 0.05 * ref.abs(), 0.0)
    scale = ad.hold_scale(name, ref, 2)
    assert err.max() <= 2e-2 * ref.abs().max()
    assert (err > 2e-2 * scale).any(-1)[off].all()


def test_bf16s_rounding_bound_sees_only_scores_at_a_midpoint():
    """The bound is 0 for a row whose scores are all far from a bf16
    rounding midpoint, and for a row with a score on one it is at least how
    far the output moves when that score rounds the other way."""
    q = torch.zeros(1, 2, 64)
    k = torch.zeros(1, 64, 64)
    q[0, 0, 0] = 1.00390625      # s = 1.00390625: the midpoint of bf16 1.0 and 1.0078125
    q[0, 1, 0] = 1.0             # s = 1.0 or 0: bf16 values, far from any midpoint
    k[0, 0, 0] = 1.0
    v = torch.zeros(1, 64, 64)
    v[0, 0] = 1.0                # key 0's value row: the output follows p_0 / l
    bound = ad.bf16s_rounding_bound(q, k, v, 1)
    assert torch.equal(bound[0, 1], torch.zeros(64))
    # p_0 = exp of either bf16 neighbour, rounded to bf16; the 63 other keys give 1
    p_lo, p_hi = (torch.exp(torch.tensor(x, dtype=torch.bfloat16)).float()
                  for x in (1.0, 1.0078125))
    moved = p_hi / (p_hi + 63) - p_lo / (p_lo + 63)   # o of row 0, column 0, either way
    assert (bound[0, 0] >= moved * (1 - 1e-3)).all()


def test_wrapper_refusals_on_the_cpu():
    q = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError, match="mode"):
        ad.diag(q, q, q, 2, "slice")
    with pytest.raises(ValueError, match="mode"):
        ad.diag_kt(q, q, q, 2, "nosm")
    with pytest.raises(ValueError, match="mode"):
        ad.diag_slice(q, q, q, 2, "full")
    with pytest.raises(ValueError, match="exp"):
        ad.diag_bf16s(q, q, q, 2, "bf16")


def test_shootout_runs_the_plain_versions_on_the_cpu(capsys):
    results = attn_ds1.main(["--device", "cpu", "--shape", "2,256,128,2", "--steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert [r["name"] for r in results] == list(attn_ds1.VARIANTS)
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 and r["device"] == "cpu" for r in results)
    for r in results:
        assert f"{r['name']:18s}:" in out and "cpu_ms" in out


def test_shootout_names_and_its_ds1_bounds():
    """The variants the port keeps, and the H100 bounds at ds1 (16, 4096,
    320, 5 heads) worked by hand at 1980 MHz: QK^T 2 B N^2 C = 1.718e11
    flop, the same again for PV, B H N^2 = 1.342e9 exps, 41.9 MB a tensor."""
    assert attn_ds1.VARIANTS[:6] == ("packed_fast", "packed_exact", "ones_fast", "fold_fast",
                                     "fold_exact", "bhnd_fast")
    assert attn_ds1.VARIANTS[-1] == "sdpa_flash" and len(attn_ds1.VARIANTS) == 18
    exp_per_s = attn_ds1.MUFU_PER_CLOCK * 1980e6
    qk = 2 * 16 * 4096 ** 2 * 320
    expected = {
        "packed_fast": (2 * qk / 989e12 * 1e3, "mma"),
        "diag_qk": (qk / 989e12 * 1e3, "mma"),
        "diag_exp": (16 * 5 * 4096 ** 2 / exp_per_s * 1e3, "exp"),
        "diag_fp32pv": ((qk / 989e12 + qk / 495e12) * 1e3, "mma"),
        "diag_bf16s": (2 * qk / 989e12 * 1e3, "mma"),
        "diag_bf16s_ex2": (2 * qk / 989e12 * 1e3, "mma"),
        "diag_qk_slice": (2 * 16 * 320 * (2 * 4096 + 64) / 3.35e12 * 1e3, "bytes"),
    }
    for name, (ms, term) in expected.items():
        got_ms, _, got_term = attn_ds1.bound(name, 16, 4096, 320, 5, exp_per_s)
        assert got_term == term and got_ms == pytest.approx(ms, rel=1e-12), name


def test_script_input_is_the_jax_scripts():
    x = attn_ds1.script_input(2, 8, 16, "cpu", torch.float32)
    ref = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
    np.testing.assert_array_equal(x.numpy(), ref)
