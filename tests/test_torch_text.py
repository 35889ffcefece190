"""The port's vendored CLIP BPE tokenizer against the JAX package's.

With a small merges file written here, both tokenizers are built from the
same data and must agree id for id; with the public
`bpe_simple_vocab_16e6.txt.gz` (skipped where it is not available, as
tests/test_text.py does) they must agree on real prompts too.
"""
import gzip
from pathlib import Path

import numpy as np
import pytest

from minddiffusion_tpu.text.assets import resolve_asset as jax_resolve_asset
from minddiffusion_tpu.text.bpe_clip import ClipBpeTokenizer as JaxTokenizer
from minddiffusion_tpu_torch.text import ClipBpeTokenizer, assets
from minddiffusion_tpu_torch.text.assets import resolve_asset

TEXTS = ["a photograph of an astronaut riding a horse", "", "Hello, World!! 42",
         "the the then there &amp; théâtre", " ".join(["word"] * 90)]
MERGES = ["t h", "th e</w>", "h e", "a n", "an d</w>", "o r", "e r</w>", "w o",
          "wo r", "wor d</w>", "i n", "in g</w>", "s t", "a r", "h o", "ho r"]


def _vocab_path():
    """The CLIP merges file where the JAX package finds it, else None."""
    try:
        return jax_resolve_asset("bpe_simple_vocab_16e6.txt.gz")
    except FileNotFoundError:
        return None


def check_same(ours, ref):
    assert ours.encoder == ref.encoder
    assert (ours.sot_id, ours.eot_id) == (ref.sot_id, ref.eot_id)
    np.testing.assert_array_equal(ours.tokenize(TEXTS), ref.tokenize(TEXTS))
    for text in TEXTS:
        ids = ref.encode(text)
        assert ours.encode(text) == ids
        assert ours.decode(ids) == ref.decode(ids)


def test_vendored_tokenizer_matches_jax_on_a_small_merges_file(tmp_path, monkeypatch):
    path = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + MERGES) + "\n")
    check_same(ClipBpeTokenizer(str(path)), JaxTokenizer(str(path)))
    # both packages resolve the MINDDIFFUSION_TPU_ASSETS directory first
    monkeypatch.setenv("MINDDIFFUSION_TPU_ASSETS", str(tmp_path))
    assert resolve_asset("bpe_simple_vocab_16e6.txt.gz") == str(path)
    assert ClipBpeTokenizer().encoder == JaxTokenizer().encoder
    with pytest.raises(FileNotFoundError):
        resolve_asset("bpe_simple_vocab_16e6.txt.gz", str(tmp_path / "missing.gz"))


def test_resolve_asset_reads_only_the_explicit_path_the_env_dir_and_the_repo(
        tmp_path, monkeypatch):
    monkeypatch.setenv("MINDDIFFUSION_TPU_ASSETS", str(tmp_path))
    monkeypatch.setattr(assets, "_REPO_ASSETS", tmp_path / "repo_assets")
    with pytest.raises(FileNotFoundError, match="MINDDIFFUSION_TPU_ASSETS"):
        resolve_asset("bpe_simple_vocab_16e6.txt.gz")
    (tmp_path / "repo_assets").mkdir()
    in_repo = tmp_path / "repo_assets" / "bpe_simple_vocab_16e6.txt.gz"
    in_repo.write_bytes(b"")
    assert resolve_asset("bpe_simple_vocab_16e6.txt.gz") == str(in_repo)
    in_env = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    in_env.write_bytes(b"")
    assert resolve_asset("bpe_simple_vocab_16e6.txt.gz") == str(in_env)
    repo_root = Path(assets.__file__).resolve().parents[2]
    assert (repo_root / "minddiffusion_tpu_torch").is_dir()


@pytest.mark.skipif(_vocab_path() is None, reason="CLIP BPE merges asset unavailable")
def test_vendored_tokenizer_matches_jax_on_the_clip_vocab():
    """The port gets the file the JAX package found by its explicit path, so
    the test runs wherever the JAX package finds the vocab."""
    ours, ref = ClipBpeTokenizer(_vocab_path()), JaxTokenizer()
    check_same(ours, ref)
    assert ours.encode("a photograph of an astronaut riding a horse") == [
        320, 8853, 539, 550, 18376, 6765, 320, 4558]
