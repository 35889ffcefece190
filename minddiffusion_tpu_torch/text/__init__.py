"""Tokenizers of the port (host-side, numpy)."""
from minddiffusion_tpu_torch.text.bpe_clip import ClipBpeTokenizer
from minddiffusion_tpu_torch.text.glide_text import GlideSentencePieceTokenizer
from minddiffusion_tpu_torch.text.wordpiece_zh import WordpieceZhTokenizer

__all__ = ["ClipBpeTokenizer", "GlideSentencePieceTokenizer", "WordpieceZhTokenizer"]
