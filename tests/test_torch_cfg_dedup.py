"""The port's two sampling savings against the JAX package, on the CPU in fp32.

CFG-prefix dedup (`UNetModel.forward(cfg_fold=True)`, on by default in the
txt2img and img2img pipelines) runs the UNet at batch B up to the first
cross-attention; the hoisted cross-attention K/V (`UNetModel.hoisted`,
GLIDE's encoder K/V) is computed once a sampling run. Tiny models from
tests/torch_parity.py carry the same seeded weights in both packages.

Tolerances: a UNet eval 1e-5 relative to the largest magnitude of the
reference (the fold against [x; x] in the port, and against the JAX fold);
pipelines as tests/test_torch_pipeline.py (latents 1e-3 abs, uint8 one
level); the K/V hoist computes the same operations on the same tensors, so
it is held bytewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from minddiffusion_tpu.models.unet import UNetModel as JaxUNet
from minddiffusion_tpu.core import latents as jax_latents
from minddiffusion_tpu.pipelines.stable_diffusion import _make_eps_fn, _run_sampler
from minddiffusion_tpu.utils import flags as jax_flags
from minddiffusion_tpu_torch.io.sd_weights import PREFIXES, state_dict_from_jax
from minddiffusion_tpu_torch.models import glide
from minddiffusion_tpu_torch.models.attention import CrossAttention
from minddiffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideCascadePipeline, GlideModels
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels, StableDiffusionPipeline
from minddiffusion_tpu_torch.utils import flags

SIZE, STEPS, BATCH, SCALE = 256, 5, 2, 9.0
UNET_KW = {**tp.UNET_KW, **tp.FAMILY_UNET_KW["sd2"]}
FOLD_CASES = {  # the three cases of tests/test_models.py's fold test
    "first_transformer_in_the_down_path": dict(attention_resolutions=(2, 1)),
    "mid_block_only": dict(attention_resolutions=()),
    "depth_2_folds_block_0": dict(attention_resolutions=(2,), transformer_depth=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the tier-1 command runs
    six test processes on the machine's cores, and the pipelines' many
    small CPU ops otherwise wait on each other's spinning threads (tens of
    times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_rel(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


def unet_pair(seed: int, **kw):
    """A JAX UNet and the port's with the same seeded weights (strict load)."""
    jcfg = JaxUNetConfig(**{**UNET_KW, **kw})
    jm = JaxUNet(jcfg)
    y = jnp.zeros((1,), jnp.int32) if kw.get("num_classes") else None
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, UNET_KW["context_dim"])), y=y))
    params = tp.randomize(shapes, seed)
    prefix = PREFIXES["unet"]
    sd = {k[len(prefix):]: torch.from_numpy(v)
          for k, v in state_dict_from_jax({"unet": params}, jcfg).items()}
    port = UNetModel(UNetConfig(**{**UNET_KW, **kw}))
    port.load_state_dict(sd, strict=True)
    return jm, params, port.eval()


def fold_inputs(seed: int = 0, b: int = 2, hw: int = 16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ctx2 = rng.standard_normal((2 * b, 7, UNET_KW["context_dim"])).astype(np.float32)
    return x, np.array([3, 700][:b], np.int32), ctx2


# ---- the UNet's cfg_fold ------------------------------------------------------

@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_unet_cfg_fold_matches_the_duplicated_batch_and_jax(case):
    jm, params, port = unet_pair(1, **FOLD_CASES[case])
    x, t, ctx2 = fold_inputs()
    ref = jax.jit(lambda p, x, t, c: jm.apply(p, x, t, c, cfg_fold=True))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx2))
    with torch.no_grad():
        folded = port(tp.t(x), tp.t(t), tp.t(ctx2), cfg_fold=True)
        dup = port(tp.t(np.concatenate([x, x])), tp.t(np.concatenate([t, t])), tp.t(ctx2))
    assert folded.shape == dup.shape == (4, 16, 16, 4)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert_rel(folded.numpy(), dup.numpy())
    assert_rel(folded.numpy(), ref)


def test_unet_cfg_fold_with_a_batch_1_timestep():
    _, _, port = unet_pair(2)
    x, _, ctx2 = fold_inputs()
    t1 = torch.tensor([500])
    with torch.no_grad():
        folded = port(tp.t(x), t1, tp.t(ctx2), cfg_fold=True)
        dup = port(tp.t(np.concatenate([x, x])), t1, tp.t(ctx2))
    assert_rel(folded.numpy(), dup.numpy())


def test_unet_cfg_fold_refusals():
    _, _, port = unet_pair(3)
    x, t, ctx2 = fold_inputs()
    with torch.no_grad(), pytest.raises(ValueError, match="context"):
        port(tp.t(x), tp.t(t), None, cfg_fold=True)
    _, _, labelled = unet_pair(3, num_classes=5)
    with torch.no_grad(), pytest.raises(ValueError, match="class labels"):
        labelled(tp.t(x), tp.t(t), tp.t(ctx2), cfg_fold=True, y=torch.tensor([1, 2, 1, 2]))
    # a UNet whose only spatial transformer (the middle one) is taken out
    bare = UNetModel(UNetConfig(**{**UNET_KW, "attention_resolutions": ()})).eval()
    bare.middle_block[1] = torch.nn.Identity()
    with torch.no_grad(), pytest.raises(ValueError, match="spatial transformer"):
        bare(tp.t(x), tp.t(t), tp.t(ctx2), cfg_fold=True)


def test_class_conditioned_unet_matches_jax_through_a_strict_load():
    jm, params, port = unet_pair(4, num_classes=5)
    assert port.label_emb.weight.shape == (5, 4 * UNET_KW["model_channels"])
    x, t, ctx2 = fold_inputs()
    y = np.array([3, 1], np.int32)
    ref = jax.jit(lambda p, x, t, c, y: jm.apply(p, x, t, c, y=y))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx2[:2]), jnp.asarray(y))
    with torch.no_grad():
        got = port(tp.t(x), tp.t(t), tp.t(ctx2[:2]), y=tp.t(y))
        other = port(tp.t(x), tp.t(t), tp.t(ctx2[:2]), y=torch.tensor([1, 3]))
        with pytest.raises(ValueError, match="class labels"):
            port(tp.t(x), tp.t(t), tp.t(ctx2[:2]))
    assert_rel(got.numpy(), ref)
    assert (got - other).abs().max() > 1e-4


# ---- the flags -------------------------------------------------------------------

@pytest.mark.parametrize("hoist", [None, "1", "0", "force", "kv", "kv,wino", "wino"])
@pytest.mark.parametrize("dedup", [None, "0", "1"])
def test_flag_grammar_follows_jax(monkeypatch, hoist, dedup):
    for var, value in (("MDT_HOIST", hoist), ("MDT_CFG_DEDUP", dedup)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    got, ref = flags.flags(), jax_flags.flags()
    # what each package hoists: SD's U, the K/V, GLIDE's U
    assert (got.cfg_dedup, got.hoist, got.hoist_kv) == (
        ref.cfg_dedup, ref.hoist, ref.hoist and ref.hoist_kv)
    # the deliberate divergence: the port's GLIDE keeps its U cache under "1"
    assert got.hoist_wino_glide == (ref.hoist and ref.hoist_wino_glide
                                    or hoist in (None, "1", "force"))


@pytest.mark.parametrize("raw", ["bogus", "kv,bogus", "yes"])
def test_malformed_hoist_raises(monkeypatch, raw):
    monkeypatch.setenv("MDT_HOIST", raw)
    with pytest.raises(ValueError, match="MDT_HOIST"):
        flags.flags()


# ---- the pipelines ---------------------------------------------------------------

@pytest.fixture(scope="module")
def parity():
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=5)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 1000, (BATCH, 77)).astype(np.int32)
    uncond = np.zeros((BATCH, 77), np.int32)
    noise = rng.standard_normal((BATCH, SIZE // 8, SIZE // 8, 4)).astype(np.float32)
    return jm, params, tp.port_models(jm, params, attn_impl="fast"), tokens, uncond, noise


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_txt2img_with_both_savings_matches_jax_hoisting(parity, monkeypatch, sampler):
    """Both savings on in both packages; the JAX package hoists off a TPU
    under MDT_HOIST=force."""
    for var in ("MDT_CFG_DEDUP", "MDT_HOIST"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MDT_HOIST", "force")
    jm, params, pm, tokens, uncond, noise = parity
    tok, unc, x_T = jnp.asarray(tokens), jnp.asarray(uncond), jnp.asarray(noise)
    h8 = SIZE // 8

    @jax.jit
    def jax_pipeline(params):
        """The JAX txt2img program (StableDiffusionPipeline.build_txt2img's
        `fn` with its explicit-noise input), returning its latent too."""
        ctx2 = jm.text_encoder.apply(params["text"], jnp.concatenate([unc, tok]))
        eps_fn = _make_eps_fn(jm, params, ctx2, SCALE, sample_shape=(BATCH, h8, h8))
        z = _run_sampler(sampler, eps_fn, x_T, jm.schedule, STEPS, jax.random.PRNGKey(0))
        img = jm.vae.apply(params["vae"], jax_latents.unscale_latents(z, jm.scale_factor),
                           method=jm.vae.decode)
        return z, jax_latents.unit_range_to_uint8(img)

    z_ref, img_ref = (np.asarray(a) for a in jax_pipeline(params))
    fn = StableDiffusionPipeline(pm).build_txt2img(SIZE, SIZE, STEPS, sampler, SCALE, BATCH)
    args = (pm, tp.t(tokens), tp.t(uncond), None)
    with Calls(pm.unet) as calls:
        z = fn.latents(*args, noise=tp.t(noise)).numpy()
    assert calls.prefix_batches == {BATCH} and calls.to_k == calls.sites
    img = fn(*args, noise=tp.t(noise)).numpy()
    assert np.abs(z_ref).max() > 0.1
    np.testing.assert_allclose(z, z_ref, atol=1e-3, rtol=0)
    assert np.abs(img.astype(np.int32) - img_ref.astype(np.int32)).max() <= 1


class Calls:
    """Counts, while open, the batch of each UNet input conv call (the
    prefix's batch) and the calls of every cross-attention's to_k and
    to_v (and of every GLIDE encoder_kv)."""

    def __init__(self, net: torch.nn.Module):
        self.net = net

    def __enter__(self):
        self.prefix_batches, self.to_k, self.to_v, self.encoder_kv = set(), 0, 0, 0
        hooks = []
        unet = getattr(self.net, "input_blocks", None)
        if unet is not None:
            hooks.append(unet[0][0].register_forward_hook(
                lambda m, args, out: self.prefix_batches.add(args[0].shape[0])))
        cross = [m for name, m in self.net.named_modules()
                 if isinstance(m, CrossAttention) and name.endswith("attn2")]
        self.sites = len(cross)
        for m in cross:
            hooks.append(m.to_k.register_forward_hook(lambda *a: self.bump("to_k")))
            hooks.append(m.to_v.register_forward_hook(lambda *a: self.bump("to_v")))
        enc = [m.encoder_kv for m in self.net.modules()
               if isinstance(m, glide.GlideAttentionBlock) and hasattr(m, "encoder_kv")]
        self.sites += len(enc)
        hooks += [m.register_forward_hook(lambda *a: self.bump("encoder_kv")) for m in enc]
        self.hooks = hooks
        return self

    def bump(self, name: str) -> None:
        setattr(self, name, getattr(self, name) + 1)

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


@pytest.fixture(scope="module")
def port_sd():
    """Port-only tiny models of the sd2 and wukong-inpaint families, seeded."""
    def make(family):
        kw = {**tp.UNET_KW, **tp.FAMILY_UNET_KW[family]}
        return SDModels.create(
            family=family, dtype=torch.float32, device="cpu",
            generator=torch.Generator().manual_seed(6), unet_config=UNetConfig(**kw),
            vae_config=tp.VAEConfig(**tp.VAE_KW),
            text_config=tp.CLIPTextConfig(use_quick_gelu=family != "sd2", **tp.CLIP_KW))
    return {"sd2": make("sd2"), "wukong-inpaint": make("wukong-inpaint")}


def tokens(seed: int, b: int = BATCH) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(1, 1000, (b, 77)))


def run_pipeline(kind: str, models: SDModels, seed: int = 0):
    """One call of the txt2img (DDIM), img2img or inpaint pipeline at 64^2,
    3 steps, on `seed`'s prompt, with fixed draws."""
    gen = torch.Generator().manual_seed(11)
    pipe, tok, unc = StableDiffusionPipeline(models), tokens(seed), torch.zeros(BATCH, 77).long()
    image = torch.rand(BATCH, 64, 64, 3, generator=gen) * 2 - 1
    if kind == "txt2img":
        return pipe.build_txt2img(64, 64, 3, "ddim", SCALE, BATCH).latents(
            models, tok, unc, torch.Generator().manual_seed(1))
    if kind == "img2img":
        return pipe.build_img2img(64, 64, 4, 0.75, SCALE).latents(
            models, image, tok, unc, torch.Generator().manual_seed(1))
    mask = torch.zeros(BATCH, 64, 64, 1)
    mask[:, 16:48, 16:48] = 1.0
    return pipe.build_inpaint(64, 64, 3, "plms", 7.5).latents(
        models, image, mask, tok, unc, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("kind,dedup,prefix", [
    ("txt2img", None, BATCH), ("img2img", None, BATCH), ("inpaint", None, 2 * BATCH),
    ("txt2img", "0", 2 * BATCH), ("img2img", "0", 2 * BATCH)])
def test_pipelines_run_the_prefix_at_b_where_dedup_applies(port_sd, monkeypatch, kind,
                                                             dedup, prefix):
    """txt2img and img2img run the UNet's prefix at batch B by default and
    at 2B under MDT_CFG_DEDUP=0; inpaint (channel concat) always at 2B. The
    fold gives the result of the duplicated batch within fp32 sums."""
    monkeypatch.delenv("MDT_HOIST", raising=False)
    monkeypatch.setenv("MDT_CFG_DEDUP", "0")
    models = port_sd["wukong-inpaint" if kind == "inpaint" else "sd2"]
    ref = run_pipeline(kind, models)
    if dedup is None:
        monkeypatch.delenv("MDT_CFG_DEDUP")
    with Calls(models.unet) as calls:
        got = run_pipeline(kind, models)
    assert calls.prefix_batches == {prefix}
    assert_rel(got.numpy(), ref.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["txt2img", "img2img", "inpaint"])
def test_kv_hoist_runs_the_projections_once_a_call_and_changes_no_bit(port_sd, monkeypatch,
                                                                      kind):
    """Two calls in a row with different prompts: each gets its own K/V,
    computed once a call, and equals its unhoisted result bytewise."""
    monkeypatch.delenv("MDT_CFG_DEDUP", raising=False)
    models = port_sd["wukong-inpaint" if kind == "inpaint" else "sd2"]
    monkeypatch.setenv("MDT_HOIST", "0")
    with Calls(models.unet) as plain:
        refs = [run_pipeline(kind, models, seed) for seed in (0, 1)]
    monkeypatch.delenv("MDT_HOIST")
    with Calls(models.unet) as hoisted:
        got = [run_pipeline(kind, models, seed) for seed in (0, 1)]
    assert hoisted.to_k == hoisted.to_v == 2 * hoisted.sites
    assert plain.to_k > 2 * plain.sites
    assert not torch.equal(refs[0], refs[1])
    for g, r in zip(got, refs):
        assert torch.equal(g, r)
    assert all(m.kv_cache is None for m in models.unet.modules() if hasattr(m, "kv_cache"))


def test_kv_cache_recomputes_for_another_context_inside_the_scope(port_sd):
    """A call with another context tensor inside one scope gets its own K/V;
    the first context's come back after it."""
    unet = port_sd["sd2"].unet
    x, t, ctx2 = (torch.from_numpy(a) for a in fold_inputs())
    other = ctx2.flip(0).contiguous()
    with torch.inference_mode():
        ref_a = unet(x, t, ctx2, cfg_fold=True)
        ref_b = unet(x, t, other, cfg_fold=True)
        with unet.hoisted(), Calls(unet) as calls:
            a1 = unet(x, t, ctx2, cfg_fold=True)
            b1 = unet(x, t, other, cfg_fold=True)
            a2 = unet(x, t, ctx2, cfg_fold=True)
    assert calls.to_k == 3 * calls.sites
    assert torch.equal(a1, ref_a) and torch.equal(a2, ref_a) and torch.equal(b1, ref_b)


def test_kv_cache_is_bypassed_where_autograd_records(port_sd):
    unet = port_sd["sd2"].unet
    ctx = torch.randn(2, 77, UNET_KW["context_dim"], generator=torch.Generator().manual_seed(5))
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(6))
    t = torch.tensor([10, 500])
    with unet.hoisted(), Calls(unet) as calls:
        unet(x, t, ctx).square().mean().backward()
        unet(x, t, ctx)
    assert calls.to_k == 2 * calls.sites
    unet.zero_grad(set_to_none=True)


# ---- GLIDE -----------------------------------------------------------------------

GLIDE_UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                  channel_mult=(1, 2), num_head_channels=16)
GLIDE_XF = dict(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64)


@pytest.fixture(scope="module")
def glide_models():
    return GlideModels.create(
        dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(7),
        base_respacing="3", sr_respacing="ddim3",
        base_unet=glide.GlideUNetConfig(**GLIDE_UNET),
        sr_unet=glide.GlideUNetConfig(in_channels=6, **GLIDE_UNET),
        xf=glide.XfConfig(**GLIDE_XF), with_srgan=False)


def test_glide_encoder_kv_hoist_reproduces_the_direct_denoise(glide_models):
    """tests/test_glide.py's capture round trip: inside the scope a second
    x with the same encoding gives the direct result bytewise, and the
    encoder K/V run once."""
    base = glide_models.base
    rng = np.random.default_rng(12)
    tok = torch.from_numpy(rng.integers(0, 64, (2, 8)))
    msk = torch.ones(2, 8, dtype=torch.long)
    xs = [torch.from_numpy(rng.standard_normal((2, s, s, 3)).astype(np.float32))
          for s in (16, 8)]
    t = torch.tensor([3, 7])
    with torch.inference_mode():
        xf_proj, xf_out = base.encode_text(tok, msk)
        direct = [base.denoise(x, t, xf_proj, xf_out) for x in xs]
        with base.hoisted(), Calls(base) as calls:
            hoisted = [base.denoise(x, t, xf_proj, xf_out) for x in xs]
    assert calls.sites > 0 and calls.encoder_kv == calls.sites
    for d, h in zip(direct, hoisted):
        for a, b in zip(d, h):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["per_generation", "per_step"])
def test_glide_cascade_is_unchanged_by_the_hoist(glide_models, monkeypatch, mode):
    """The whole cascade with MDT_HOIST at its default equals MDT_HOIST=0
    bytewise. per_generation runs the base's encoder K/V once; per_step,
    whose uncond half is re-encoded every step, runs them every step under
    either value."""
    b = 2
    fn = GlideCascadePipeline(glide_models).build_generate(
        batch_size=b, base_size=16, sr_size=32, uncond_mode=mode)
    tok = torch.from_numpy(np.random.default_rng(14).integers(0, 64, (b, 8)))
    msk = torch.ones(b, 8, dtype=torch.long)
    runs, counts = {}, {}
    for hoist in ("0", "1"):
        monkeypatch.setenv("MDT_HOIST", hoist)
        with Calls(glide_models.base) as base_calls:
            img = fn.base_stage(glide_models, tok, msk, torch.Generator().manual_seed(3),
                                None, None, None, None)
        with Calls(glide_models.super_res) as sr_calls:
            sr = fn.sr_stage(glide_models, img, tok, msk, torch.Generator().manual_seed(4),
                             None)
        runs[hoist], counts[hoist] = (img, sr), (base_calls.encoder_kv, sr_calls.encoder_kv)
    steps = glide_models.base_schedule.num_timesteps
    sites = base_calls.sites
    sr_steps = glide_models.sr_schedule.num_timesteps
    assert counts["0"] == (steps * sites, sr_steps * sr_calls.sites)
    base_once = steps * sites if mode == "per_step" else sites
    assert counts["1"] == (base_once, sr_calls.sites)
    for a, r in zip(runs["1"], runs["0"]):
        assert torch.equal(a, r)
