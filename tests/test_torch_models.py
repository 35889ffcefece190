"""Port models vs the JAX modules on a tiny SD2-flavoured config, fp32 CPU.

Both packages carry the same seeded random weights (tests/torch_parity.py),
converted by the port's `state_dict_from_jax` and loaded strictly.
Tolerance: 1e-4 abs.
"""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.io.sd_weights import export_sd_checkpoint
from minddiffusion_tpu_torch.io.sd_weights import PREFIXES, state_dict_from_jax
from minddiffusion_tpu_torch.ops import winograd

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=0)
    return jm, params, tp.port_models(jm, params)


def unet_inputs(seed=0, b=2, hw=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, 32)).astype(np.float32)
    return x, np.array([981, 41][:b], np.int32), ctx


@pytest.mark.parametrize("wino_min_c_in", [512, 32])
def test_unet_eps_matches_jax(pair, monkeypatch, wino_min_c_in):
    """wino_min_c_in=32 routes every 32^2/16^2 conv with C_in >= 32 through the
    Winograd path with its GN+SiLU prologue (the kernel's plain version here)."""
    monkeypatch.setattr(winograd, "MIN_C_IN", wino_min_c_in)
    jm, params, pm = pair
    x, t, ctx = unet_inputs()
    ref = jm.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = pm.unet(tp.t(x), tp.t(t), tp.t(ctx))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1   # eps is not trivially zero
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_hoisted_winograd_routes_the_gated_convs(pair, monkeypatch):
    monkeypatch.setattr(winograd, "MIN_C_IN", 32)
    _, _, pm = pair
    transforms = []
    transform = winograd.transform_weights
    monkeypatch.setattr(winograd, "transform_weights",
                        lambda k: transforms.append(k) or transform(k))
    x, t, ctx = unet_inputs()
    with torch.no_grad():
        ref = pm.unet(tp.t(x), tp.t(t), tp.t(ctx))
        per_call = len(transforms)
        with pm.unet.hoisted_winograd():
            got = pm.unet(tp.t(x), tp.t(t), tp.t(ctx))
            again = pm.unet(tp.t(x), tp.t(t), tp.t(ctx))
            hoisted = [m for m in pm.unet.modules() if getattr(m, "wino_cache", None)]
    # 32^2: down/up resblocks at C_in 32 and 64; 16^2: level-1 resblocks + upsample
    assert len(hoisted) == per_call > 0
    # two evals inside the context transform each routed weight once
    assert len(transforms) == 2 * per_call
    assert all(m.wino_cache is None for m in hoisted)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(again, ref, atol=1e-6, rtol=0)


def test_vae_decode_matches_jax(pair):
    jm, params, pm = pair
    z = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    ref = jm.vae.apply(params["vae"], jnp.asarray(z), method=jm.vae.decode)
    with torch.no_grad():
        got = pm.vae.decode(tp.t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_vae_encode_matches_jax(pair):
    jm, params, pm = pair
    img = np.random.default_rng(3).uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
    ref = jm.vae.apply(params["vae"], jnp.asarray(img), method=jm.vae.encode)
    with torch.no_grad():
        got = pm.vae.encode(tp.t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_clip_encode_matches_jax(pair):
    jm, params, pm = pair
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 50000, (3, 77)).astype(np.int32)   # some past the vocab: clipped
    ref = jm.text_encoder.apply(params["text"], jnp.asarray(tokens))
    with torch.no_grad():
        got = pm.text_encoder(tp.t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_state_dict_from_jax_equals_export_and_loads_strictly(pair):
    jm, params, pm = pair
    ours = state_dict_from_jax(params, jm.unet.config)
    ref, report = export_sd_checkpoint(params, jm.unet.config)
    assert report == []
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    port_keys = {PREFIXES[kind] + k for kind, m in pm.modules().items()
                 for k in m.state_dict()}
    assert port_keys == set(ref)


def test_load_state_dict_rejects_missing_and_unknown_keys(pair):
    jm, params, pm = pair
    sd = state_dict_from_jax(params, jm.unet.config)
    extra = dict(sd, **{"model.diffusion_model.bogus.weight": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError):
        pm.load_state_dict(extra)
    missing = {k: v for k, v in sd.items() if not k.endswith("out.2.bias")}
    with pytest.raises(RuntimeError):
        pm.load_state_dict(missing)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import minddiffusion_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'minddiffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert int(out.stdout.strip()) >= 17


def test_port_sources_import_no_jax_anywhere():
    """Also imports inside functions (run only on some paths, so the
    subprocess check above does not see them): no module of the port, and
    not chip_smoke.py, names JAX or the JAX package in any import."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "minddiffusion_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "minddiffusion_tpu"}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in banned]
    assert len(files) > 20 and not bad, bad
