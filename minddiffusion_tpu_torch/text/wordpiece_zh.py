"""Chinese BERT-style wordpiece tokenizer of the Wukong-Huahua family (the
port's copy of minddiffusion_tpu/text/wordpiece_zh.py).

Canonical BERT wordpiece algorithm over the public `vocab_zh.txt` (21128
entries): control/invalid-char cleanup, whitespace around CJK codepoints,
lowercase + accent strip, punctuation splitting, greedy longest-match-first
wordpiece with "##" continuations, [UNK] fallback. Tokenize contract matches
the wukong encoder wrapper (wukong-huahua/ldm/modules/encoders/modules.py:
32-50): [CLS] ... [SEP], context 77, zero-padded, truncation keeps [SEP].
`vocab_zh.txt` resolves like the BPE vocab (text/assets.py): an explicit
path, then MINDDIFFUSION_TPU_ASSETS, then `assets/` in the repository.
"""
from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence

import numpy as np

from minddiffusion_tpu_torch.text.assets import resolve_asset

CLS = "[CLS]"
SEP = "[SEP]"
UNK = "[UNK]"


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordpieceZhTokenizer:
    def __init__(self, vocab_path: Optional[str] = None, context_length: int = 77,
                 max_chars_per_word: int = 100):
        path = resolve_asset("vocab_zh.txt", vocab_path)
        with open(path, encoding="utf-8") as f:
            vocab = [line.strip() for line in f]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.context_length = context_length
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = self.encoder[CLS]
        self.sep_id = self.encoder[SEP]
        self.unk_id = self.encoder[UNK]

    # -- basic tokenization -------------------------------------------------

    def _basic(self, text: str) -> List[str]:
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            cleaned.append(" " if _is_whitespace(ch) else ch)
        spaced = []
        for ch in "".join(cleaned):
            if _is_cjk(ord(ch)):
                spaced += [" ", ch, " "]
            else:
                spaced.append(ch)
        words = "".join(spaced).split()

        out: List[str] = []
        for word in words:
            word = "".join(
                c for c in unicodedata.normalize("NFD", word.lower())
                if unicodedata.category(c) != "Mn"
            )
            current = ""
            for ch in word:
                if _is_punct(ch):
                    if current:
                        out.append(current)
                        current = ""
                    out.append(ch)
                else:
                    current += ch
            if current:
                out.append(current)
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                cand = ("##" if start else "") + word[start:end]
                if cand in self.encoder:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    # -- public API ----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._basic(text):
            ids.extend(self.encoder[p] for p in self._wordpiece(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            tok = self.decoder.get(int(i), UNK)
            if tok in (CLS, SEP, "[PAD]"):
                continue
            out.append(tok[2:] if tok.startswith("##") else tok)
        return "".join(out)

    def tokenize(self, texts) -> np.ndarray:
        """List[str] -> (B, 77) int32: [CLS] ... [SEP], zero-padded."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        out = np.zeros((len(texts), n), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.cls_id] + self.encode(text) + [self.sep_id]
            if len(ids) > n:
                ids = ids[: n - 1] + [self.sep_id]
            out[row, : len(ids)] = ids
        return out
