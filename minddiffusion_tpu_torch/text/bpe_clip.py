"""CLIP byte-pair-encoding tokenizer (English SD family); the port's copy of
minddiffusion_tpu/text/bpe_clip.py.

Implements the canonical OpenAI CLIP BPE algorithm over the public
`bpe_simple_vocab_16e6.txt.gz` merges file, with the SD tokenize contract
(reference: stablediffusionv2/ldm/models/clip_zh/simple_tokenizer.py:77-169):
vocab 49408 (= 256 bytes x2 + 48894 merges + SOT/EOT), `<|startoftext|>` /
`<|endoftext|>` wrapping, fixed context length 77, zero padding, and
truncation that preserves the EOT in the last slot.

Host-side only: tokenization never runs on the device.
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np

from minddiffusion_tpu_torch.text.assets import resolve_asset

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@lru_cache()
def byte_to_unicode() -> dict:
    """Reversible byte <-> printable-unicode map (the GPT-2/CLIP trick):
    printable bytes map to themselves, the rest to U+0100+. Insertion order
    (printable ranges first) is load-bearing: it fixes the vocab ids of the
    256 base tokens ('a</w>' must be id 320 for CLIP-checkpoint parity)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    mapping = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


def _pairs(word: Sequence[str]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


# CLIP's pattern uses \p{L}/\p{N}; stdlib-re equivalents: [^\W\d_]+ for letter
# runs, \d for single digits, (?:[^\s\w]|_)+ for punctuation runs.
_TOKEN_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE,
)


class ClipBpeTokenizer:
    def __init__(self, merges_path: Optional[str] = None, context_length: int = 77):
        path = resolve_asset("bpe_simple_vocab_16e6.txt.gz", merges_path)
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines[1 : 49152 - 256 - 2 + 1]]

        b2u = byte_to_unicode()
        vocab: List[str] = list(b2u.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.b2u = b2u
        self.u2b = {c: b for b, c in b2u.items()}
        self.context_length = context_length
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._bpe_cache = {SOT: SOT, EOT: EOT}

    # -- core BPE ---------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for tok in _TOKEN_RE.findall(text):
            mapped = "".join(self.b2u[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        # map unicode chars back to bytes FIRST ("</w>" is plain ASCII and
        # survives), then utf-8 decode, then turn word-end markers into spaces
        raw = bytearray(self.u2b[c] for c in text if c in self.u2b)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- SD contract ------------------------------------------------------

    def tokenize(self, texts) -> np.ndarray:
        """List[str] -> (B, 77) int32, SOT ... EOT, zero-padded; long prompts
        truncated to keep EOT last (reference tokenize :151-169)."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        out = np.zeros((len(texts), n), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > n:
                ids = ids[: n - 1] + [self.eot_id]
            out[row, : len(ids)] = ids
        return out
