"""Minimal from-scratch sentencepiece runtime (no external dependency); the
port's copy of minddiffusion_tpu/text/sentencepiece_mini.py.

The reference's Chinese GLIDE tokenizer wraps the sentencepiece library over
`cog-pretrain.model`
(Taichu-GLIDE/model/glide_text2im/tokenizer/chinese_tokenizer.py:15-163).
This module implements the inference path directly:

  * a hand-rolled protobuf wire-format parser for `ModelProto`
    (pieces: piece/score/type; trainer_spec: model_type/unk_id;
    normalizer_spec: add_dummy_prefix);
  * unigram segmentation as a Viterbi pass over a piece trie;
  * BPE segmentation as best-scored adjacent merges (scores are -rank);
  * the standard normalizer: NFKC, whitespace -> U+2581, dummy prefix.

Only encoding/decoding is supported (no training, no precompiled charsmap —
NFKC via unicodedata approximates it; exact for CJK text, which is the use
case here).
"""
from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Tuple

_WS = "▁"  # ▁

# piece types (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _fields(buf: bytes):
    """Yields (field_number, wire_type, value_bytes_or_int)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


class SentencePieceModel:
    """Parsed model: pieces, scores, types, model_type, unk_id."""

    def __init__(self, data: bytes):
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = 1  # UNIGRAM
        self.unk_id = 0
        self.add_dummy_prefix = True
        for field, wt, val in _fields(data):
            if field == 1 and wt == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
            elif field == 2 and wt == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:   # model_type
                        self.model_type = v2
                    elif f2 == 40 and w2 == 0:  # unk_id
                        self.unk_id = v2
            elif field == 3 and wt == 2:  # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:   # add_dummy_prefix
                        self.add_dummy_prefix = bool(v2)

        self.piece_to_id: Dict[str, int] = {}
        for i, p in enumerate(self.pieces):
            self.piece_to_id.setdefault(p, i)
        for i, t in enumerate(self.types):
            if t == UNKNOWN:
                self.unk_id = i
                break
        self._min_score = min(self.scores) if self.scores else 0.0
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)


class SentencePieceProcessor:
    """Inference-only drop-in for the sentencepiece API surface the
    reference tokenizer uses: Load/GetPieceSize/EncodeAsIds/DecodeIds."""

    def __init__(self, model_path: str = None, model_proto: bytes = None):
        self.model = None
        if model_proto is not None:
            self.model = SentencePieceModel(model_proto)
        elif model_path is not None:
            self.Load(model_path)

    def Load(self, path: str) -> None:
        with open(path, "rb") as f:
            self.model = SentencePieceModel(f.read())

    def GetPieceSize(self) -> int:
        return len(self.model.pieces)

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # remove_extra_whitespaces
        if self.model.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", _WS)

    # -- unigram (Viterbi) --------------------------------------------------

    def _encode_unigram(self, s: str) -> List[int]:
        m = self.model
        n = len(s)
        NEG = float("-inf")
        unk_score = m._min_score - 10.0
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # unknown single char fallback
            cand = best[i] + unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, m.unk_id)
            for ln in range(1, min(m._max_piece_len, n - i) + 1):
                pid = m.piece_to_id.get(s[i:i + ln])
                if pid is None or m.types[pid] in (CONTROL, UNUSED):
                    continue
                cand = best[i] + m.scores[pid]
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = (i, pid)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        return ids[::-1]

    # -- BPE ----------------------------------------------------------------

    def _encode_bpe(self, s: str) -> List[int]:
        m = self.model
        parts = list(s)
        while True:
            best_score, best_i = None, -1
            for i in range(len(parts) - 1):
                pid = m.piece_to_id.get(parts[i] + parts[i + 1])
                if pid is None or m.types[pid] != NORMAL:
                    continue
                sc = m.scores[pid]
                if best_score is None or sc > best_score:
                    best_score, best_i = sc, i
            if best_i < 0:
                break
            parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [m.piece_to_id.get(p, m.unk_id) for p in parts]

    # -- public API ---------------------------------------------------------

    def EncodeAsIds(self, text: str) -> List[int]:
        s = self._normalize(text)
        if not s:
            return []
        if self.model.model_type == 2:  # BPE
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def EncodeAsPieces(self, text: str) -> List[str]:
        return [self.model.pieces[i] for i in self.EncodeAsIds(text)]

    def DecodeIds(self, ids) -> str:
        text = "".join(self.model.pieces[int(i)] for i in ids
                       if 0 <= int(i) < len(self.model.pieces)
                       and self.model.types[int(i)] == NORMAL)
        return text.replace(_WS, " ").strip()
