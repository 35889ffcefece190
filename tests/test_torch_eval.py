"""The port's eval harness (eval/clip_score.py, eval/fid.py, io/clip_weights.py,
models/clip_vision.py, utils/img_utils.py) against the JAX package's, on the
CPU in fp32.

No CLIP checkpoint is in the repository, so both scorers carry the same
seeded random weights: an OpenCLIP-layout dict of numpy arrays goes through
the JAX `convert_clip_checkpoint` into flax and through the port's into
torch, and both score the same images and tokens (1e-5). The HF layout is
held against transformers' own CLIPModel (skipped without transformers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddiffusion_tpu.eval import clip_score as jax_cs
from minddiffusion_tpu.eval import fid as jax_fid
from minddiffusion_tpu.io.clip_weights import convert_clip_checkpoint as jax_convert
from minddiffusion_tpu.utils import img_utils as jax_img
from minddiffusion_tpu_torch.eval import (CLIPScoreConfig, CLIPScorer, clip_fid, clip_score_fn,
                                          frechet_distance, gaussian_stats, image_features_fn,
                                          preprocess_uint8)
from minddiffusion_tpu_torch.io.clip_weights import convert_clip_checkpoint
from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
from minddiffusion_tpu_torch.models.clip_vision import CLIPVisionConfig
from minddiffusion_tpu_torch.utils import img_utils

TOL = 1e-5


def openclip_dict(config: CLIPScoreConfig, seed: int) -> dict:
    """Seeded OpenCLIP-layout weights for `config`: the port's scorer names
    with the text tower's `text.` dropped (OpenCLIP's own names), matrices
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), vectors N(0, 0.1^2),
    embeddings N(0, 0.02^2), and OpenCLIP's logit_scale buffer."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in CLIPScorer(config).state_dict().items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if "embedding" in name:
            arr = rng.normal(0, 0.02, shape)
        elif "ln_" in name and name.endswith(".weight"):
            arr = 1.0 + rng.normal(0, 0.1, shape)
        elif len(shape) >= 2:
            # OpenCLIP's two projections are (in, out); torch weights (out, in, ...)
            fan_in = shape[0] if name in ("visual.proj", "text_projection") else np.prod(shape[1:])
            arr = rng.normal(0, float(fan_in) ** -0.5, shape)
        else:
            arr = rng.normal(0, 0.1, shape)
        out[name[len("text."):] if name.startswith("text.") else name] = arr.astype(np.float32)
    out["logit_scale"] = np.array(np.log(100.0), np.float32)
    return out


def images_and_tokens(seed: int, b: int, size: int, ctx: int, vocab: int):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    toks = np.zeros((b, ctx), np.int32)
    for i in range(b):
        n = 2 + i
        toks[i, :n] = rng.integers(1, vocab - 1, n)
        toks[i, n] = vocab - 1                        # EOT: the highest id
    return imgs, toks


def jax_config(config: CLIPScoreConfig) -> "jax_cs.CLIPScoreConfig":
    from minddiffusion_tpu.models.clip import CLIPTextConfig as JaxText
    from minddiffusion_tpu.models.clip_vision import CLIPVisionConfig as JaxVision

    v, t = config.vision, config.text
    return jax_cs.CLIPScoreConfig(
        vision=JaxVision(image_size=v.image_size, patch_size=v.patch_size, width=v.width,
                         layers=v.layers, heads=v.heads, embed_dim=v.embed_dim,
                         use_quick_gelu=v.use_quick_gelu),
        text=JaxText(vocab_size=t.vocab_size, width=t.width, layers=t.layers, heads=t.heads,
                     context_length=t.context_length, use_quick_gelu=t.use_quick_gelu,
                     use_exact_gelu=t.use_exact_gelu))


def port_scorer(config: CLIPScoreConfig, sd: dict) -> CLIPScorer:
    scorer = CLIPScorer.create(config, "cpu")
    converted, report = convert_clip_checkpoint(sd, config)
    assert report == []
    scorer.load_state_dict({k: torch.from_numpy(v) for k, v in converted.items()})
    return scorer


@pytest.mark.parametrize("b,h,w,size", [(2, 512, 512, 224), (3, 64, 64, 32), (2, 64, 48, 32),
                                        (1, 16, 16, 32), (2, 32, 32, 32)])
def test_preprocess_matches_jax(b, h, w, size):
    """JAX's bicubic (Keys a = -0.5, antialiased when shrinking) is torch's
    bicubic with antialias=True."""
    imgs = np.random.default_rng(h + w).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jax_cs.preprocess_uint8(jnp.asarray(imgs), size))
    got = preprocess_uint8(torch.from_numpy(imgs), size).numpy()
    assert got.shape == ref.shape == (b, size, size, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_preprocess_white_image():
    out = preprocess_uint8(torch.full((2, 64, 48, 3), 255, dtype=torch.uint8), size=32)
    expected = ((1.0 - np.array([0.48145466, 0.4578275, 0.40821073]))
                / np.array([0.26862954, 0.26130258, 0.27577711]))
    np.testing.assert_allclose(out[0, 0, 0].numpy(), expected, rtol=1e-5)


@pytest.mark.parametrize("variant", ["tiny", "tiny_exact_gelu", "tiny_quick_gelu"])
def test_scorer_matches_jax_on_shared_openclip_weights(variant):
    config = CLIPScoreConfig.tiny()
    if variant == "tiny_exact_gelu":
        config = CLIPScoreConfig(vision=config.vision, text=CLIPTextConfig(
            vocab_size=128, width=48, layers=2, heads=2, context_length=16, use_exact_gelu=True))
    elif variant == "tiny_quick_gelu":
        config = CLIPScoreConfig(
            vision=CLIPVisionConfig.tiny(use_quick_gelu=True),
            text=CLIPTextConfig(vocab_size=128, width=48, layers=2, heads=2, context_length=16,
                                use_quick_gelu=True))
    sd = openclip_dict(config, seed=0)
    imgs, toks = images_and_tokens(1, 3, 48, 16, 128)
    jcfg = jax_config(config)
    jax_params, jax_report = jax_convert(sd, jcfg)
    assert jax_report == []
    jax_scorer, jax_fn = jax_cs.clip_score_fn(jcfg)
    ref = np.asarray(jax.jit(jax_fn)(jax_params, jnp.asarray(imgs), jnp.asarray(toks)))
    pre = jax_cs.preprocess_uint8(jnp.asarray(imgs), 32)
    ref_img = np.asarray(jax_scorer.apply(jax_params, pre, method="encode_image"))
    ref_txt = np.asarray(jax_scorer.apply(jax_params, jnp.asarray(toks), method="encode_text"))

    scorer = port_scorer(config, sd)
    _, fn = clip_score_fn(config, "cpu")
    got = fn(scorer, imgs, toks).numpy()
    with torch.no_grad():
        got_img = scorer.encode_image(preprocess_uint8(torch.from_numpy(imgs), 32)).numpy()
        got_txt = scorer.encode_text(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got_img, ref_img, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_txt, ref_txt, atol=TOL, rtol=0)
    assert got.shape == (3,) and np.abs(got - ref).max() <= TOL * 100.0
    # features for CLIP-FID: the JAX image_features_fn on the same weights
    feats = image_features_fn(config, "cpu")(scorer, imgs).numpy()
    ref_feats = np.asarray(jax_fid.image_features_fn(jcfg)(jax_params, jnp.asarray(imgs)))
    np.testing.assert_allclose(feats, ref_feats, atol=TOL, rtol=0)


def test_scores_are_bounded_deterministic_and_pair_up():
    config = CLIPScoreConfig.tiny()
    scorer, fn = clip_score_fn(config, "cpu", torch.Generator().manual_seed(0))
    imgs, toks = images_and_tokens(2, 3, 32, 16, 128)
    first, second = fn(scorer, imgs, toks), fn(scorer, imgs, toks)
    assert torch.equal(first, second) and (first.abs() <= 100.0 + 1e-3).all()
    with torch.no_grad():
        ie = scorer.encode_image(preprocess_uint8(torch.from_numpy(imgs), 32))
        te = scorer.encode_text(torch.from_numpy(toks).long())
    torch.testing.assert_close(first, torch.diagonal(100.0 * ie @ te.T), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ie.norm(dim=-1), torch.ones(3), rtol=1e-5, atol=1e-5)


def test_converter_missing_keys_and_report():
    config = CLIPScoreConfig.tiny()
    sd = openclip_dict(config, seed=1)
    del sd["visual.proj"]
    sd["visual.extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="missing 1 expected CLIP keys"):
        convert_clip_checkpoint(sd, config)
    with pytest.raises(KeyError, match="missing 1 expected CLIP keys"):
        jax_convert(sd, jax_config(config))
    out, report = convert_clip_checkpoint(sd, config, allow_partial=True)
    _, jax_report = jax_convert(sd, jax_config(config), allow_partial=True)
    assert report == jax_report == ["not loaded: visual.proj", "unused ckpt key: visual.extra"]
    assert "visual.proj" not in out


def test_hf_layout_matches_transformers():
    """Random HF CLIP weights through the port's converter reproduce
    transformers' own image and text embeddings (HF names, q / k / v
    stacked, projections transposed)."""
    transformers = pytest.importorskip("transformers")
    vocab, embed = 128, 32
    hf_cfg = transformers.CLIPConfig(
        projection_dim=embed,
        vision_config=dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=256, hidden_act="gelu",
                           projection_dim=embed),
        text_config=dict(vocab_size=vocab, hidden_size=48, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=192, hidden_act="gelu",
                         max_position_embeddings=16, projection_dim=embed,
                         eos_token_id=vocab - 1))
    torch.manual_seed(7)
    model = transformers.CLIPModel(hf_cfg).eval()
    config = CLIPScoreConfig(
        vision=CLIPVisionConfig.tiny(),
        text=CLIPTextConfig(vocab_size=vocab, width=48, layers=2, heads=2, context_length=16,
                            use_exact_gelu=True))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    converted, report = convert_clip_checkpoint(sd, config)
    assert report == []
    scorer = CLIPScorer.create(config, "cpu")
    scorer.load_state_dict({k: torch.from_numpy(v) for k, v in converted.items()})
    imgs, toks = images_and_tokens(3, 2, 32, 16, vocab)
    pixels = preprocess_uint8(torch.from_numpy(imgs), 32)
    with torch.no_grad():
        ref_img = model.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))
        ref_txt = model.get_text_features(input_ids=torch.from_numpy(toks).long())
        got_img = scorer.encode_image(pixels)
        got_txt = scorer.encode_text(torch.from_numpy(toks).long())
    torch.testing.assert_close(got_img, ref_img / ref_img.norm(dim=-1, keepdim=True),
                               atol=TOL, rtol=0)
    torch.testing.assert_close(got_txt, ref_txt / ref_txt.norm(dim=-1, keepdim=True),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("n,d", [(40, 8), (6, 16), (5, 1)])
def test_fid_matches_jax(n, d):
    rng = np.random.default_rng(n * d)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (rng.standard_normal((n + 3, d)) * 1.3 + 0.2).astype(np.float32)
    for x in (a, b):
        mu, cov = gaussian_stats(torch.from_numpy(x))
        jmu, jcov = jax_fid.gaussian_stats(x)
        np.testing.assert_array_equal(mu, jmu)
        np.testing.assert_array_equal(cov, jcov)
    assert clip_fid(a, b) == jax_fid.clip_fid(a, b)
    assert clip_fid(a, a) == pytest.approx(0.0, abs=1e-6)
    assert frechet_distance(*gaussian_stats(a), *gaussian_stats(b)) == jax_fid.frechet_distance(
        *jax_fid.gaussian_stats(a), *jax_fid.gaussian_stats(b))
    with pytest.raises(ValueError, match="N>=2"):
        gaussian_stats(a[:1])


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip_score_fn(CLIPScoreConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_features_fn(CLIPScoreConfig.tiny())


def test_full_width_configs():
    h14, l14 = CLIPScoreConfig.vit_h14(), CLIPScoreConfig.vit_l14()
    jh14, jl14 = jax_cs.CLIPScoreConfig.vit_h14(), jax_cs.CLIPScoreConfig.vit_l14()
    for ours, theirs in ((h14, jh14), (l14, jl14)):
        for field in ("image_size", "patch_size", "width", "layers", "heads", "embed_dim",
                      "use_quick_gelu"):
            assert getattr(ours.vision, field) == getattr(theirs.vision, field), field
        for field in ("vocab_size", "width", "layers", "heads", "context_length",
                      "use_quick_gelu", "use_exact_gelu"):
            assert getattr(ours.text, field) == getattr(theirs.text, field), field
    assert h14.vision.grid == 16


@pytest.mark.parametrize("b,cols", [(5, None), (4, 4), (1, None)])
def test_img_utils_match_jax(tmp_path, b, cols):
    x = np.random.default_rng(b).uniform(-1.2, 1.2, (b, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(img_utils.to_uint8(x), jax_img.to_uint8(x))
    np.testing.assert_array_equal(img_utils.to_uint8(torch.from_numpy(x)), jax_img.to_uint8(x))
    u8 = jax_img.to_uint8(x)
    np.testing.assert_array_equal(img_utils.make_grid(u8, cols), jax_img.make_grid(u8, cols))
    ours = img_utils.save_image_grid(torch.from_numpy(x), str(tmp_path / "a.png"), cols)
    theirs = jax_img.save_image_grid(x, str(tmp_path / "b.png"), cols)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(theirs)))
