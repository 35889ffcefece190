"""The port's Wukong-Huahua slice against the JAX package: the attention
kernels' plain versions at SD1's head dims, the SD1 UNet with 1x1-conv
proj_in/out, the zh CLIP with QuickGELU, the strict load of every SD1 leaf,
the wordpiece tokenizer, txt2img end to end, and the `--family wukong` CLI.

Tiny "wukong" models (4 heads, 1x1-conv proj_in/out, QuickGELU CLIP) carry
the same seeded weights in both packages (tests/torch_parity.py). The JAX
attention kernels run in interpret mode on the CPU, as the JAX package's own
tests run them. Tolerances: fp32 modules 1e-5 relative to the largest
magnitude of the reference (attention, CLIP) or 1e-4 abs (UNet eps, as the
SD2 tests); final latents 1e-3 abs and uint8 images 1 level, as the SD2
txt2img test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.io.sd_weights import export_sd_checkpoint
from minddiffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from minddiffusion_tpu.ops.flash_attention import flash_attention_packed as jax_packed
from minddiffusion_tpu.pipelines.stable_diffusion import StableDiffusionPipeline as JaxPipe
from minddiffusion_tpu.text.wordpiece_zh import WordpieceZhTokenizer as JaxWordpiece
from minddiffusion_tpu_torch.cli import common as cli_common
from minddiffusion_tpu_torch.cli.txt2img import main as txt2img_main
from minddiffusion_tpu_torch.io.sd_weights import PREFIXES, state_dict_from_jax
from minddiffusion_tpu_torch.models.clip import quick_gelu
from minddiffusion_tpu_torch.models.unet import UNetConfig
from minddiffusion_tpu_torch.ops import flash_attention, winograd
from minddiffusion_tpu_torch.pipelines import stable_diffusion as port_pipe
from minddiffusion_tpu_torch.text import WordpieceZhTokenizer

SD1_HEAD_DIMS = (40, 80, 160)     # C 320, 640, 1280 over 8 heads


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_rel(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", SD1_HEAD_DIMS)
def test_packed_attention_plain_matches_pallas_at_sd1_head_dims(d, exact):
    """K1's plain version against the JAX packed kernel, 8 heads, 256 tokens."""
    rng = np.random.default_rng(d)
    q, k, v = (rand(rng, 1, 256, 8 * d) for _ in range(3))
    scale = d ** -0.5
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 8,
                     exact=exact, interpret=True)
    got = flash_attention.packed_attention_plain(tp.t(q), tp.t(k), tp.t(v), 8, scale, exact)
    # the float64 answer of the same math (q scaled and rounded to fp32 as
    # both legs round it), so a failure says which leg left it
    qh, kh, vh = (a.astype(np.float64).reshape(256, 8, d).transpose(1, 0, 2)
                  for a in ((q * np.float32(scale)).astype(np.float32), k, v))
    s = qh @ kh.transpose(0, 2, 1)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref64 = ((p / p.sum(-1, keepdims=True)) @ vh).transpose(1, 0, 2).reshape(1, 256, 8 * d)
    off = {leg: float(np.abs(np.asarray(a, np.float64) - ref64).max() / np.abs(ref64).max())
           for leg, a in (("port", got.numpy()), ("jax", ref))}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max(),
                               err_msg=f"max error relative to max |float64 answer|: {off}")


@pytest.mark.parametrize("d", SD1_HEAD_DIMS)
def test_flash_attention_plain_matches_pallas_at_sd1_head_dims(d):
    """K4's plain version against the JAX head-split kernel, 8 heads,
    Nq 200 (ragged), Nk 256 in two JAX k blocks."""
    rng = np.random.default_rng(d + 1)
    q, k, v = rand(rng, 1, 200, 8, d), rand(rng, 1, 256, 8, d), rand(rng, 1, 256, 8, d)
    scale = d ** -0.5
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                    block_q=128, block_k=128, interpret=True)
    got = flash_attention.flash_attention(tp.t(q), tp.t(k), tp.t(v), scale)
    assert_rel(got.numpy(), ref, 1e-5)


def test_kernels_take_the_sd1_head_dims():
    for c in (320, 640, 1280):
        q = torch.empty(1, 1024, c, dtype=torch.bfloat16, device="meta")
        assert flash_attention.kernel_supports(q, q, 8)
        assert c // 8 in flash_attention.FLASH_HEAD_DIMS
    odd = torch.empty(1, 1024, 384, dtype=torch.bfloat16, device="meta")
    assert not flash_attention.kernel_supports(odd, odd, 8)          # D 48
    cfg = UNetConfig.sd1()
    assert [cfg.head_split(c) for c in (320, 640, 1280)] == [(8, 40), (8, 80), (8, 160)]
    assert not cfg.use_linear_in_transformer and cfg.context_dim == 768
    assert UNetConfig.sd1_inpaint().in_channels == 9


@pytest.fixture(scope="module")
def pair():
    jm = tp.jax_models(family="wukong")
    params = tp.jax_params(jm, seed=5)
    return jm, params, tp.port_models(jm, params, family="wukong")


@pytest.mark.parametrize("wino_min_c_in", [512, 32])
def test_sd1_unet_eps_matches_jax(pair, monkeypatch, wino_min_c_in):
    """The conv-proj SD1 UNet; wino_min_c_in=32 routes the 32^2/16^2 convs
    through the Winograd path (its plain version here)."""
    monkeypatch.setattr(winograd, "MIN_C_IN", wino_min_c_in)
    jm, params, pm = pair
    rng = np.random.default_rng(0)
    x, ctx = rand(rng, 2, 32, 32, 4), rand(rng, 2, 77, 32)
    t = np.array([981, 41], np.int32)
    ref = jm.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = pm.unet(tp.t(x), tp.t(t), tp.t(ctx))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    proj = pm.unet.input_blocks[1][1].proj_in
    assert proj.weight.shape == (32, 32, 1, 1)        # LDM conv layout


def test_zh_clip_with_quick_gelu_matches_jax(pair):
    jm, params, pm = pair
    tokens = np.random.default_rng(2).integers(0, 21128, (3, 77)).astype(np.int32)
    ref = jm.text_encoder.apply(params["text"], jnp.asarray(tokens))
    with torch.no_grad():
        got = pm.text_encoder(tp.t(tokens))
    assert_rel(got.numpy(), ref, 1e-5)
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(quick_gelu(tp.t(x)).numpy(),
                               x / (1 + np.exp(-1.702 * x)), atol=1e-6)


@pytest.mark.parametrize("family", ["wukong", "wukong-inpaint"])
def test_sd1_state_dict_equals_export_and_loads_strictly(family):
    jm = tp.jax_models(family=family)
    params = tp.jax_params(jm, seed=6)
    ours = state_dict_from_jax(params, jm.unet.config)
    ref, report = export_sd_checkpoint(params, jm.unet.config)
    assert report == []
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    pm = tp.port_models(jm, params, family=family)     # strict load
    port_keys = {PREFIXES[kind] + k for kind, m in pm.modules().items()
                 for k in m.state_dict()}
    assert port_keys == set(ref)
    assert ref["model.diffusion_model.input_blocks.1.1.proj_in.weight"].ndim == 4
    in_ch = 9 if family == "wukong-inpaint" else 4
    assert ref["model.diffusion_model.input_blocks.0.0.weight"].shape[1] == in_ch


ZH_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "来", "自", "太", "空", "的", "长",
            "城", "照", "片", "猫", "a", "cat", "##s", "photo", "!", "，", "。",
            "hello", "##world", "1", "##2", "e"]
ZH_TEXTS = ["来自太空的长城照片", "a cat，photos!", "HelloWorld 12 ！", "",
            "\tthé cat\x00\n猫猫", "未知字 xyz", "猫" * 120]


def test_wordpiece_tokenizer_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "vocab_zh.txt"
    path.write_text("\n".join(ZH_VOCAB) + "\n", encoding="utf-8")
    ours, ref = WordpieceZhTokenizer(str(path)), JaxWordpiece(str(path))
    assert ours.encoder == ref.encoder
    out = ours.tokenize(ZH_TEXTS)
    np.testing.assert_array_equal(out, ref.tokenize(ZH_TEXTS))
    for text in ZH_TEXTS:
        ids = ref.encode(text)
        assert ours.encode(text) == ids and ours.decode(ids) == ref.decode(ids)
    assert out.shape == (len(ZH_TEXTS), 77) and out.dtype == np.int32
    assert list(out[0, :11]) == [2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 3]    # CJK split
    assert out[-1, 0] == 2 and out[-1, 76] == 3                          # truncated, [SEP] kept
    assert 1 in out[5]                                                    # [UNK]
    monkeypatch.setenv("MINDDIFFUSION_TPU_ASSETS", str(tmp_path))
    assert WordpieceZhTokenizer().encoder == ours.encoder
    assert isinstance(cli_common.tokenizer_for("wukong"), WordpieceZhTokenizer)


SIZE, STEPS, BATCH, SCALE = 256, 5, 2, 7.5


def test_wukong_txt2img_matches_jax(pair):
    """DPM-Solver++ 2M through the tiny SD1 models at 256^2 (the ds1
    self-attention crosses the packed-kernel gate), exact softmax."""
    jm, params, pm = pair
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 21128, (BATCH, 77)).astype(np.int32)
    uncond = np.zeros((BATCH, 77), np.int32)
    noise = rand(rng, BATCH, SIZE // 8, SIZE // 8, 4)
    img_ref = np.asarray(JaxPipe(jm).build_txt2img(
        SIZE, SIZE, STEPS, "dpm", SCALE, BATCH)(params, jnp.asarray(tokens),
                                                 jnp.asarray(uncond),
                                                 jax.random.PRNGKey(0),
                                                 noise=jnp.asarray(noise)))
    fn = port_pipe.StableDiffusionPipeline(pm).build_txt2img(SIZE, SIZE, STEPS, "dpm",
                                                            SCALE, BATCH)
    img = fn(pm, tp.t(tokens), tp.t(uncond), None, noise=tp.t(noise)).numpy()
    assert img.shape == (BATCH, SIZE, SIZE, 3) and img.dtype == np.uint8
    assert img.std() > 1.0
    assert np.abs(img.astype(np.int32) - img_ref.astype(np.int32)).max() <= 1


class _StubTokenizer:
    def tokenize(self, texts):
        return np.stack([np.full(77, len(t) % 50, np.int32) for t in texts])


def test_wukong_txt2img_cli_defaults_and_smoke(tmp_path, capsys, monkeypatch):
    """--family wukong takes the JAX CLI's defaults (dpm, 15 steps from the
    default 50, scale 7.5) and runs the SD1 models end to end."""
    monkeypatch.setattr(cli_common, "tokenizer_for", lambda family: _StubTokenizer())
    seen = []
    build = port_pipe.StableDiffusionPipeline.build_txt2img

    def spy(self, **kw):
        seen.append(kw)
        return build(self, **{**kw, "num_steps": 2})

    monkeypatch.setattr(port_pipe.StableDiffusionPipeline, "build_txt2img", spy)
    outdir = str(tmp_path / "samples")
    paths = txt2img_main(["--prompt", "来自太空的长城照片", "--family", "wukong",
                          "--debug_tiny", "--device", "cpu", "--H", "64", "--W", "64",
                          "--n_samples", "2", "--outdir", outdir])
    assert seen[0]["sampler"] == "dpm" and seen[0]["num_steps"] == 15
    assert seen[0]["guidance_scale"] == 7.5
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    assert "saved 2 images" in capsys.readouterr().out
    models = cli_common.build_sd("wukong", "fp32", torch.device("cpu"), tiny=True)
    assert not models.unet.config.use_linear_in_transformer
    assert models.text_encoder.config.use_quick_gelu
