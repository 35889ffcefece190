"""Tokenizers of the port (host-side, numpy)."""
from minddiffusion_tpu_torch.text.bpe_clip import ClipBpeTokenizer

__all__ = ["ClipBpeTokenizer"]
