"""The port's GLIDE slice against the JAX package, on the CPU in fp32.

Tiny models (`tests/test_glide.py`'s config: UNet ch 32, mult (1, 2), one res
block, attention at ds 2, head_ch 16; xf 32 wide, 2 layers, ctx 8, vocab 64)
carry the same seeded weights in both packages: every JAX param leaf,
the zero-init heads and the SRGAN's batch statistics included, is drawn
with numpy and carried across by `io/glide_weights.py` into a strict load.
Random draws cross the same way: the test makes the JAX package's own draws
with its `jax.random` calls and hands them to the port.

Tolerances (fp32 on both sides): schedules 1e-6 relative; modules 1e-5
relative to the largest magnitude of the reference (2e-5 for a whole
UNet); sampler loops and the cascade's fp32 stages 1e-4 abs; uint8 stages
at most one level. The cascade's super-res stage runs "ddim3" (t 668, 334,
0): a first DDIM step at t 999 multiplies the UNet's eps by
sqrt(1 / abar - 1) ~ 158 and the two fp32 UNets' 1e-6 differences with it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.core import schedules as jax_sched
from minddiffusion_tpu.models import glide as jax_glide
from minddiffusion_tpu.models import unet as jax_unet
from minddiffusion_tpu.models.srgan import SRGANGenerator as JaxSRGAN
from minddiffusion_tpu.models.srgan import pixel_shuffle_2x as jax_pixel_shuffle
from minddiffusion_tpu.ops import attention as jax_attention
from minddiffusion_tpu.ops.flash_attention import flash_attention_packed as jax_packed
from minddiffusion_tpu.pipelines import glide_cascade as jax_cascade
from minddiffusion_tpu.samplers import ancestral as jax_ancestral
from minddiffusion_tpu.text import glide_text as jax_glide_text
from minddiffusion_tpu.utils import flags as jax_flags
from minddiffusion_tpu_torch.cli.glide_txt2img import main as glide_main
from minddiffusion_tpu_torch.core import schedules
from minddiffusion_tpu_torch.io.glide_weights import (
    state_dict_from_jax, variables_to_state_dict)
from minddiffusion_tpu_torch.models import glide
from minddiffusion_tpu_torch.models.srgan import SRGANGenerator, pixel_shuffle_2x
from minddiffusion_tpu_torch.models.unet import ResBlock
from minddiffusion_tpu_torch.ops import attention, flash_attention
from minddiffusion_tpu_torch.pipelines.glide_cascade import (
    GlideCascadePipeline, GlideModels, quantize_roundtrip)
from minddiffusion_tpu_torch.samplers import ancestral
from minddiffusion_tpu_torch.text import glide_text
from minddiffusion_tpu_torch.utils import flags

UNET_KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_head_channels=16)
XF_KW = dict(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64)
B, BASE, SR = 2, 16, 32


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_rel(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


def randomize(variables, seed):
    """tp.randomize, with the BatchNorm variances in [4, 4.5): each BatchNorm
    then halves its input, so the 16 residual blocks do not blow the
    activations up (with variances near 1 they reach ~1e3 before the tanh)."""
    out = dict(tp.randomize(variables, seed))
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: np.abs(a) + 4.0 if str(p[-1].key) == "var" else a,
            out["batch_stats"])
    return out


def jax_init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def load(module, variables):
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in variables_to_state_dict(variables).items()},
                           strict=True)
    return module.eval()


def tokens_and_mask(rng, b=B):
    toks = rng.integers(0, XF_KW["n_vocab"], (b, XF_KW["text_ctx"])).astype(np.int32)
    mask = np.ones_like(toks)
    mask[:, 5:] = 0
    return toks, mask


# ---- schedules, samplers, flags ----------------------------------------------

@pytest.mark.parametrize("name", ["linear_plain", "squaredcos_cap_v2"])
@pytest.mark.parametrize("spacing", ["60", "fast27", "ddim25", "10,5,3", "4"])
def test_respaced_schedule_matches_jax(name, spacing):
    betas = schedules.make_beta_schedule(1000, schedule=name)
    np.testing.assert_array_equal(betas, jax_sched.make_beta_schedule(name, 1000))
    use = schedules.space_timesteps(1000, spacing)
    assert use == jax_sched.space_timesteps(1000, spacing)
    got = schedules.respace_schedule(betas, use)
    ref = jax_sched.respace_schedule(betas, use)
    assert got.num_timesteps == ref.num_timesteps == len(use)
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    np.testing.assert_array_equal(got.timestep_map.numpy(), np.asarray(ref.timestep_map))


def toy_model(x, t, *rest):
    """A smooth model of (x, t): eps and v in the ranges a UNet gives."""
    eps = 0.8 * x + 0.3 * (t.astype(jnp.float32) / 1000.0) if isinstance(x, jnp.ndarray) \
        else 0.8 * x + 0.3 * (t.float() / 1000.0)
    v = (0.5 * x[..., ::-1] if isinstance(x, jnp.ndarray) else 0.5 * x.flip(-1))
    return eps, v


def test_posterior_helpers_and_p_mean_variance_match_jax():
    rng = np.random.default_rng(0)
    betas = schedules.make_beta_schedule(1000, schedule="squaredcos_cap_v2")
    use = schedules.space_timesteps(1000, "7")
    port_s, jax_s = schedules.respace_schedule(betas, use), jax_sched.respace_schedule(betas, use)
    x, eps = rand(rng, 2, 4, 4, 3), rand(rng, 2, 4, 4, 3)
    t = np.array([5, 1])
    np.testing.assert_allclose(
        port_s.predict_xstart_from_eps(tp.t(x), tp.t(t), tp.t(eps)).numpy(),
        jax_s.predict_xstart_from_eps(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps)),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        port_s.q_posterior_mean(tp.t(eps), tp.t(x), tp.t(t)).numpy(),
        jax_s.q_posterior_mean(jnp.asarray(eps), jnp.asarray(x), jnp.asarray(t)),
        atol=1e-6, rtol=0)
    for step in (6, 3, 0):
        got = ancestral.p_mean_variance(toy_model, port_s, tp.t(x), step)
        ref = jax_ancestral.p_mean_variance(toy_model, jax_s, jnp.asarray(x),
                                            jnp.array([step]))
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("takes_key", [False, True])
def test_p_sample_loop_matches_jax_on_its_draws(takes_key):
    rng = np.random.default_rng(1)
    betas = schedules.make_beta_schedule(1000, schedule="squaredcos_cap_v2")
    use = schedules.space_timesteps(1000, "5")
    port_s, jax_s = schedules.respace_schedule(betas, use), jax_sched.respace_schedule(betas, use)
    x_T = rand(rng, 2, 4, 4, 3)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 5)
    if takes_key:
        split = [jax.random.split(k) for k in keys]
        noise = [jax.random.normal(k[0], x_T.shape) for k in split]
        args = [float(jax.random.uniform(k[1])) for k in split]
        jax_fn = lambda x, t, k: toy_model(x + jax.random.uniform(k), t)  # noqa: E731
        port_fn = lambda x, t, a: toy_model(x + a, t)  # noqa: E731
    else:
        noise = [jax.random.normal(k, x_T.shape) for k in keys]
        args, jax_fn, port_fn = None, toy_model, toy_model
    ref = jax_ancestral.p_sample_loop(jax_fn, jnp.asarray(x_T), jax_s, key,
                                      model_takes_key=takes_key)
    got = ancestral.p_sample_loop(port_fn, tp.t(x_T), port_s,
                                  noise=[np.asarray(n) for n in noise], step_args=args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(eta):
    rng = np.random.default_rng(2)
    betas = schedules.make_beta_schedule(1000, schedule="linear_plain")
    use = schedules.space_timesteps(1000, "fast27")
    port_s, jax_s = schedules.respace_schedule(betas, use), jax_sched.respace_schedule(betas, use)
    x_T = rand(rng, 2, 4, 4, 3)
    key = jax.random.PRNGKey(4)
    noise = [np.asarray(jax.random.normal(k, x_T.shape)) for k in jax.random.split(key, 27)]
    ref = jax_ancestral.ddim_sample_loop(toy_model, jnp.asarray(x_T), jax_s, eta=eta, key=key)
    got = ancestral.ddim_sample_loop(toy_model, tp.t(x_T), port_s, eta=eta, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("raw", ["", "attn_route=256", "s2d=0,skip_join=split,attn_route=384",
                                 "skip_join=bogus", "attn_route", "tail=1"])
def test_glide_tune_grammar_matches_jax(raw):
    """attn_route parses as in the JAX package; its TPU-only rewrite keys
    (s2d, skip_join) raise in the port, which has no such rewrites."""
    keys = {part.split("=")[0].strip() for part in raw.split(",") if "=" in part}
    if keys & {"s2d", "skip_join"}:
        with pytest.raises(ValueError, match="no such rewrite"):
            flags.parse_glide_tune(raw)
        return
    try:
        ref = jax_flags._parse_glide_tune(raw)
    except ValueError:
        with pytest.raises(ValueError):
            flags.parse_glide_tune(raw)
        return
    assert flags.parse_glide_tune(raw) == (
        {"glide_attn_route": ref["glide_attn_route"]} if "glide_attn_route" in ref else {})


# ---- the attention route at the GLIDE sites ---------------------------------

def glide_sites():
    """(label, nq, nk, C, heads) of every GLIDE UNet attention site: 128
    text tokens prepended to the spatial keys, head_ch 64."""
    sites = []
    for stage, size, mc, mult, attn in (("base", 64, 192, (1, 2, 3, 4), (2, 4, 8)),
                                        ("sr", 256, 192, (1, 1, 2, 2, 4, 4), (8, 16, 32))):
        for level, m in enumerate(mult):
            ds = 2 ** level
            if ds in attn:
                n, c = (size // ds) ** 2, m * mc
                sites.append((f"{stage} ds{ds}", n, n + 128, c, c // 64))
        n, c = (size // 2 ** (len(mult) - 1)) ** 2, mult[-1] * mc
        sites.append((f"{stage} mid", n, n + 128, c, c // 64))
    return sites


def jax_route(monkeypatch, nq, nk, c, heads, min_q):
    calls = []
    monkeypatch.setattr(jax_attention, "_pallas_available", lambda: True)
    monkeypatch.setattr(jax_attention, "_packed_ad",
                        lambda q, *a: calls.append("K1") or q)
    monkeypatch.setattr(jax_attention, "_flash_ad", lambda q, *a: calls.append("K4") or q)
    jax.eval_shape(lambda a, b_: jax_attention.packed_attention(
        a, b_, b_, heads, block_q=1024, min_q=min_q),
        jax.ShapeDtypeStruct((1, nq, c), jnp.bfloat16),
        jax.ShapeDtypeStruct((1, nk, c), jnp.bfloat16))
    return calls[0] if calls else "einsum"


@pytest.mark.parametrize("min_q", [None, 256, 64])
def test_route_follows_jax_at_every_glide_site(monkeypatch, min_q):
    for label, nq, nk, c, heads in glide_sites():
        ref = jax_route(monkeypatch, nq, nk, c, heads, min_q)
        got = "K1" if attention.packed_route(nq, nk, c, 1024, min_q) else (
            "K4" if nq >= 1024 and nk >= 512 else "einsum")
        assert got == ref, (label, min_q, got, ref)
    sites = {s[0]: s for s in glide_sites()}
    assert attention.packed_route(*sites["base ds2"][1:4], block_q=1024)
    assert attention.packed_route(*sites["sr ds8"][1:4], block_q=1024)
    assert not attention.packed_route(*sites["sr ds16"][1:4], block_q=1024)
    assert attention.packed_route(*sites["sr ds16"][1:4], block_q=1024, min_q=256)


def test_glide_block_sends_the_attn_route_tier_to_k1(monkeypatch):
    """MDT_GLIDE_TUNE=attn_route=256 sends the 16² tier (nq 256, nk 384) to
    K1 through GlideAttentionBlock; without it the site runs einsum."""
    calls = []
    monkeypatch.setattr(flash_attention, "flash_attention_packed",
                        lambda q, *a, **kw: calls.append(q.shape) or torch.empty_like(q))
    blk = glide.GlideAttentionBlock(768, 12, 512).to("meta")
    x = torch.empty(1, 16, 16, 768, device="meta")
    enc = torch.empty(1, 128, 512, device="meta")
    blk(x, enc)
    assert calls == []
    monkeypatch.setenv("MDT_GLIDE_TUNE", "attn_route=256")
    blk(x, enc)
    assert calls == [(1, 256, 768)]


def test_k1_plain_matches_pallas_at_the_attn_route_tier():
    """K1's plain version at nq 256, nk 384 (128 text keys first) against the
    JAX packed kernel in interpret mode, as the JAX route sends it."""
    rng = np.random.default_rng(5)
    c, heads = 128, 2
    q, k, v = rand(rng, 1, 256, c), rand(rng, 1, 384, c), rand(rng, 1, 384, c)
    assert attention.packed_route(256, 384, c, 1024, 256)
    scale = (c // heads) ** -0.5
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, heads,
                     block_q=256, exact=True, interpret=True)
    got = flash_attention.packed_attention_plain(tp.t(q), tp.t(k), tp.t(v), heads, scale)
    assert_rel(got.numpy(), ref, 1e-5)


# ---- modules -----------------------------------------------------------------

def test_xf_matches_jax_and_clamps_token_ids():
    rng = np.random.default_rng(6)
    cfg = jax_glide.XfConfig(**XF_KW)
    toks, mask = tokens_and_mask(rng)
    toks[0, 1], toks[1, 2] = 70, -3                           # clamped, as mode='clip'
    jm = jax_glide.XfTextEncoder(cfg, 48)
    v = jax_init(jm, jnp.asarray(toks), jnp.asarray(mask))
    ref_proj, ref_out = jm.apply(v, jnp.asarray(toks), jnp.asarray(mask))
    port = load(glide.XfTextEncoder(glide.XfConfig(**XF_KW), 48), v)
    with torch.no_grad():
        proj, out = port(tp.t(toks), tp.t(mask))
    assert_rel(proj.numpy(), ref_proj, 1e-5)
    assert_rel(out.numpy(), ref_out, 1e-5)
    strict = load(glide.XfTextEncoder(glide.XfConfig(debug_tokens=True, **XF_KW), 48), v)
    with pytest.raises(ValueError, match="out of range"):
        strict(tp.t(toks), tp.t(mask))


@pytest.mark.parametrize("with_encoder", [True, False])
def test_glide_attention_block_matches_jax(with_encoder):
    rng = np.random.default_rng(7)
    x, enc = rand(rng, 2, 8, 8, 32), rand(rng, 2, 8, 24)
    jm = jax_glide.GlideAttentionBlock(heads=2)
    args = (jnp.asarray(x), jnp.asarray(enc) if with_encoder else None)
    v = jax_init(jm, *args)
    port = load(glide.GlideAttentionBlock(32, 2, 24 if with_encoder else None), v)
    with torch.no_grad():
        got = port(tp.t(x), tp.t(enc) if with_encoder else None)
    assert_rel(got.numpy(), jm.apply(v, *args), 1e-5)


@pytest.mark.parametrize("kind", ["scale_shift", "up", "down", "plain_skip"])
def test_resblock_forms_match_jax(kind):
    rng = np.random.default_rng(8)
    cin, cout = (32, 48) if kind == "plain_skip" else (32, 32)
    kw = dict(use_scale_shift_norm=kind != "plain_skip", up=kind == "up",
              down=kind == "down")
    x, emb = rand(rng, 2, 8, 8, cin), rand(rng, 2, 64)
    jm = jax_unet.ResBlock(out_channels=cout, **kw)
    v = jax_init(jm, jnp.asarray(x), jnp.asarray(emb))
    port = load(ResBlock(cin, cout, 64, **kw), v)
    with torch.no_grad():
        got = port(tp.t(x), tp.t(emb))
    assert got.shape == {"up": (2, 16, 16, 32), "down": (2, 4, 4, 32)}.get(kind, (2, 8, 8, cout))
    assert_rel(got.numpy(), jm.apply(v, jnp.asarray(x), jnp.asarray(emb)), 1e-5)


@pytest.fixture(scope="module")
def unets():
    """The tiny base and super-res models of both packages, same weights."""
    xf = jax_glide.XfConfig(**XF_KW)
    base = jax_glide.Text2ImUNet(jax_glide.GlideUNetConfig(**UNET_KW), xf)
    sr = jax_glide.SuperResText2ImUNet(jax_glide.GlideUNetConfig(in_channels=6, **UNET_KW), xf)
    toks = jnp.zeros((1, 8), jnp.int32)
    vb = jax_init(base, jnp.zeros((1, BASE, BASE, 3)), jnp.zeros((1,), jnp.int32), toks,
                  toks, seed=1)
    vs = jax_init(sr, jnp.zeros((1, SR, SR, 3)), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, BASE, BASE, 3)), toks, toks, seed=2)
    pxf = glide.XfConfig(**XF_KW)
    pb = load(glide.Text2ImUNet(glide.GlideUNetConfig(**UNET_KW), pxf), vb)
    ps = load(glide.SuperResText2ImUNet(glide.GlideUNetConfig(in_channels=6, **UNET_KW), pxf), vs)
    return base, vb, pb, sr, vs, ps


def test_text2im_denoise_matches_jax(unets):
    jm, v, port, *_ = unets
    rng = np.random.default_rng(9)
    toks, mask = tokens_and_mask(rng)
    x = rand(rng, B, BASE, BASE, 3)
    for t in ([999], [17, 400]):
        t_ = np.array(t, np.int32)
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(t_), jnp.asarray(toks), jnp.asarray(mask))
        with torch.no_grad():
            got = port(tp.t(x), tp.t(t_), tp.t(toks), tp.t(mask))
        for a, r in zip(got, ref):
            assert a.shape == (B, BASE, BASE, 3)
            assert_rel(a.numpy(), r, 2e-5)


def test_superres_denoise_matches_jax(unets):
    *_, jm, v, port = unets
    rng = np.random.default_rng(10)
    toks, mask = tokens_and_mask(rng)
    x, low = rand(rng, B, SR, SR, 3), rand(rng, B, BASE, BASE, 3)
    t_ = np.array([250], np.int32)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(t_), jnp.asarray(low),
                   jnp.asarray(toks), jnp.asarray(mask))
    with torch.no_grad():
        got = port(tp.t(x), tp.t(t_), tp.t(low), tp.t(toks), tp.t(mask))
    for a, r in zip(got, ref):
        assert_rel(a.numpy(), r, 2e-5)


def test_bilinear_resize_matches_jax_at_the_edges():
    rng = np.random.default_rng(11)
    low = rand(rng, 1, 16, 16, 3)
    ref = jax.image.resize(jnp.asarray(low), (1, 64, 64, 3), method="bilinear")
    got = torch.nn.functional.interpolate(tp.t(low).permute(0, 3, 1, 2), size=(64, 64),
                                          mode="bilinear", align_corners=False)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, :2, :2], np.broadcast_to(low[:, :1, :1], (1, 2, 2, 3)),
                               atol=1e-6, rtol=0)


def test_pixel_shuffle_keeps_the_jax_channel_order():
    x = np.arange(2 * 3 * 2 * 16, dtype=np.float32).reshape(2, 3, 2, 16)
    got = pixel_shuffle_2x(tp.t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle(jnp.asarray(x))))
    np.testing.assert_array_equal(got[0, 0, 1], x[0, 0, 0, 4:8])   # (i, j) = (0, 1)
    torch_order = torch.nn.functional.pixel_shuffle(tp.t(x).permute(0, 3, 1, 2), 2)
    assert not np.array_equal(torch_order.permute(0, 2, 3, 1).numpy(), got)


def test_srgan_matches_jax_with_batch_stats():
    rng = np.random.default_rng(12)
    x = np.tanh(rand(rng, 1, 8, 8, 3))
    jm = JaxSRGAN(upscale_factor=4, channels=16)
    v = jax_init(jm, jnp.asarray(x), seed=3)
    assert "batch_stats" in v
    port = load(SRGANGenerator(upscale_factor=4, channels=16), v)
    with torch.no_grad():
        got = port(tp.t(x))
    assert got.shape == (1, 32, 32, 3)
    assert_rel(got.numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)



@pytest.mark.parametrize("deterministic,enabled", [(True, True), (False, False)])
def test_srgan_switches_off_tf32_only(monkeypatch, deterministic, enabled):
    """Inside the SRGAN's forward cuDNN's TF32 is off and the caller's other
    cuDNN settings hold; afterwards the caller's TF32 setting is back."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", deterministic)
    monkeypatch.setattr(cudnn, "enabled", enabled)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    seen = []
    port = SRGANGenerator(upscale_factor=2, channels=8, n_res=1)
    port.conv2.register_forward_hook(
        lambda *_: seen.append((cudnn.allow_tf32, cudnn.deterministic, cudnn.enabled)))
    with torch.no_grad():
        port(torch.zeros(1, 4, 4, 3))
    assert seen == [(False, deterministic, enabled)]
    assert cudnn.allow_tf32

def test_tokenizer_matches_jax_on_a_synthetic_model(tmp_path):
    from test_text import _make_model

    pieces = [("<unk>", 0.0, 2), ("▁", -2.0, 1), ("你", -3.0, 1), ("好", -3.0, 1),
              ("你好", -4.0, 1), ("▁你好", -9.0, 1), ("a", -5.0, 1), ("b", -5.0, 1),
              ("ab", -7.0, 1)]
    path = tmp_path / "toy.model"
    path.write_bytes(_make_model(pieces))
    ref = jax_glide_text.GlideSentencePieceTokenizer(str(path))
    tok = glide_text.GlideSentencePieceTokenizer(str(path))
    assert (tok.n_vocab, tok.end_token) == (ref.n_vocab, ref.end_token)
    for text in ("你好", "你好ab", "你ж", "ab 你"):
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text) + [tok.end_token]) == ref.decode(ref.encode(text))
    for got, want in zip(glide_text.prepare_cond_tokens(tok, "你好ab", 3, 6),
                         jax_glide_text.prepare_cond_tokens(ref, "你好ab", 3, 6)):
        np.testing.assert_array_equal(got, want)


# ---- the cascade ---------------------------------------------------------------

def jax_float_stages(jm, params, toks, mask, key, mode, scale=5.0):
    """The JAX cascade's fp32 stages, with the calls and draws of
    `GlideCascadePipeline.build_generate` (no xf hoist: the CPU takes none)."""
    vocab, ctx = XF_KW["n_vocab"], XF_KW["text_ctx"]
    k_unc, k_base, k_sr, key = jax.random.split(key, 4)
    pb, ps = params["base"], params["super_res"]

    def enc(t, m):
        return jm.base.apply(pb, t, m, method=jm.base.encode_text)

    def cfg_denoise(x, t, xp, xo):
        eps2, v2 = jm.base.apply(pb, jnp.concatenate([x, x]), t, xp, xo,
                                 method=jm.base.denoise)
        c, u = jnp.split(eps2, 2)
        return u + scale * (c - u), jnp.split(v2, 2)[0]

    unc_mask = jnp.ones_like(mask)
    draws = {}
    if mode == "per_generation":
        unc = jax.random.randint(k_unc, (B, ctx), 1, vocab - 1, jnp.int32)
        draws["uncond_tokens"] = np.asarray(unc)
        xp, xo = enc(jnp.concatenate([toks, unc]), jnp.concatenate([mask, unc_mask]))
        model_fn = lambda x, t: cfg_denoise(x, t, xp, xo)  # noqa: E731
    else:
        xpc, xoc = enc(toks, mask)

        def model_fn(x, t, k):
            row = jax.random.randint(k, (ctx,), 1, vocab - 1, jnp.int32)
            xpu, xou = enc(jnp.broadcast_to(row, (B, ctx)), unc_mask)
            return cfg_denoise(x, t, jnp.concatenate([xpc, xpu]), jnp.concatenate([xoc, xou]))
    x_T = jax.random.normal(k_base, (B, BASE, BASE, 3))
    draws["noise"] = np.asarray(x_T)
    n = jm.base_schedule.num_timesteps
    keys = jax.random.split(jax.random.fold_in(key, 0), n)
    if mode == "per_generation":
        draws["step_noise"] = np.stack([jax.random.normal(k, x_T.shape) for k in keys])
    else:
        pairs = [jax.random.split(k) for k in keys]
        draws["step_noise"] = np.stack([jax.random.normal(p[0], x_T.shape) for p in pairs])
        draws["uncond_rows"] = np.stack(
            [jax.random.randint(p[1], (ctx,), 1, vocab - 1, jnp.int32) for p in pairs])
    img64 = jax_ancestral.p_sample_loop(model_fn, x_T, jm.base_schedule,
                                        key=jax.random.fold_in(key, 0),
                                        model_takes_key=mode == "per_step")
    low = jax_cascade.quantize_roundtrip(img64)
    xps, xos = jm.super_res.apply(ps, toks, mask, method=jm.super_res.encode_text)
    sr_noise = jax.random.normal(k_sr, (B, SR, SR, 3))
    draws["sr_noise"] = np.asarray(sr_noise)
    img256 = jax_ancestral.ddim_sample_loop(
        lambda x, t: jm.super_res.apply(ps, x, t, low, xps, xos, method=jm.super_res.denoise),
        0.997 * sr_noise, jm.sr_schedule)
    return np.asarray(img64), np.asarray(img256), draws


@pytest.mark.parametrize("mode", ["per_generation", "per_step"])
def test_cascade_matches_jax(unets, mode):
    base, vb, _, sr, vs, _ = unets
    with_srgan = mode == "per_generation"
    jm = jax_cascade.GlideModels.create(
        dtype=jnp.float32, base_respacing="3", sr_respacing="ddim3",
        base_unet=base.unet_config, sr_unet=sr.unet_config, xf=base.xf_config,
        with_srgan=with_srgan)
    params = {"base": vb, "super_res": vs}
    if with_srgan:
        params["srgan"] = jax_init(jm.srgan, jnp.zeros((1, 8, 8, 3)), seed=4)
    pm = GlideModels.create(
        dtype=torch.float32, device="cpu", base_respacing="3", sr_respacing="ddim3",
        base_unet=glide.GlideUNetConfig(**UNET_KW),
        sr_unet=glide.GlideUNetConfig(in_channels=6, **UNET_KW),
        xf=glide.XfConfig(**XF_KW), with_srgan=with_srgan)
    pm.load_state_dict(state_dict_from_jax(params))
    toks, mask = tokens_and_mask(np.random.default_rng(13))
    key = jax.random.PRNGKey(21)
    ref64, ref256, draws = jax_float_stages(jm, params, jnp.asarray(toks), jnp.asarray(mask),
                                            key, mode)
    fn = GlideCascadePipeline(pm).build_generate(batch_size=B, base_size=BASE, sr_size=SR,
                                                 uncond_mode=mode)
    tt, mm = tp.t(toks).long(), tp.t(mask).long()
    img64 = fn.base_stage(pm, tt, mm, None, draws.get("uncond_tokens"), draws["noise"],
                          draws["step_noise"], draws.get("uncond_rows"))
    np.testing.assert_allclose(img64.numpy(), ref64, atol=1e-4, rtol=0)
    img256 = fn.sr_stage(pm, tp.t(ref64), tt, mm, None, draws["sr_noise"])
    np.testing.assert_allclose(img256.numpy(), ref256, atol=1e-4, rtol=0)
    out = fn(pm, toks, mask, None, **{k: v for k, v in draws.items()})
    ref_out = jax_cascade.GlideCascadePipeline(jm).build_generate(
        batch_size=B, base_size=BASE, sr_size=SR, uncond_mode=mode)(
        params, jnp.asarray(toks), jnp.asarray(mask), key)
    assert set(out) == set(ref_out) == ({"base", "super_res", "srgan"} if with_srgan
                                        else {"base", "super_res"})
    for stage, img in out.items():
        assert img.dtype == torch.uint8 and img.shape == ref_out[stage].shape
        diff = np.abs(img.numpy().astype(int) - np.asarray(ref_out[stage]).astype(int))
        assert diff.max() <= 1, (stage, diff.max())


def test_quantize_roundtrip_matches_jax():
    x = np.array([-1.3, -1.0, -0.5004, 0.0, 0.33333, 1.0, 1.2], np.float32)
    np.testing.assert_array_equal(quantize_roundtrip(tp.t(x)).numpy(),
                                  np.asarray(jax_cascade.quantize_roundtrip(jnp.asarray(x))))


def test_glide_cli_end_to_end(tmp_path, capsys):
    saved = glide_main(["--prompt", "x", "--debug_tiny", "--device", "cpu", "--dtype", "fp32",
                        "--pics_generated", "2", "--denoise_steps", "2",
                        "--super_res_steps", "2", "--outdir", str(tmp_path)])
    assert {k: len(v) for k, v in saved.items()} == {"base": 2, "super_res": 2, "srgan": 2}
    from PIL import Image
    assert Image.open(saved["srgan"][0]).size == (128, 128)
    assert "RANDOM weights" in capsys.readouterr().out


def test_glide_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        glide_main(["--prompt", "x", "--debug_tiny"])


def test_glide_models_refuse_fp32_on_cuda():
    with pytest.raises(ValueError, match="bfloat16"):
        GlideModels.create(dtype=torch.float32, device="cuda")
