"""GLIDE tokenizer (port of minddiffusion_tpu/text/glide_text.py): the Chinese
sentencepiece model and the padded-tokens-and-mask helpers.

  * zh: a sentencepiece model (`cog-pretrain.model`), n_vocab = pieces + 1,
    the extra id being the end / pad token. The port always reads it with
    its own runtime, `sentencepiece_mini.py`.
  * padded_tokens_and_mask: truncate to text_ctx, pad with the end token,
    mask 1 on real tokens.
  * prepare_cond_tokens: the cond batch; the pipeline draws the random
    uncond tokens itself.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from minddiffusion_tpu_torch.text.sentencepiece_mini import SentencePieceProcessor


class GlideSentencePieceTokenizer:
    """Chinese GLIDE tokenizer over a sentencepiece model file."""

    def __init__(self, model_path: str):
        self.sp = SentencePieceProcessor(model_path)

    @property
    def n_vocab(self) -> int:
        return self.sp.GetPieceSize() + 1   # +1: the end / pad token

    @property
    def end_token(self) -> int:
        return self.n_vocab - 1

    def encode(self, text: str) -> List[int]:
        return list(self.sp.EncodeAsIds(text))

    def decode(self, ids) -> str:
        return self.sp.DecodeIds([int(i) for i in ids if int(i) != self.end_token])


def padded_tokens_and_mask(tokens: List[int], text_ctx: int, end_token: int
                           ) -> Tuple[List[int], List[int]]:
    """Truncate / pad with end_token; mask 1 on real tokens."""
    tokens = list(tokens[:text_ctx])
    pad = text_ctx - len(tokens)
    return tokens + [end_token] * pad, [1] * len(tokens) + [0] * pad


def prepare_cond_tokens(tokenizer, prompt: str, batch: int, text_ctx: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, mask), each (batch, text_ctx) int32: the prompt on every row."""
    toks, mask = padded_tokens_and_mask(tokenizer.encode(prompt), text_ctx,
                                        tokenizer.end_token)
    return (np.tile(np.asarray(toks, np.int32), (batch, 1)),
            np.tile(np.asarray(mask, np.int32), (batch, 1)))
