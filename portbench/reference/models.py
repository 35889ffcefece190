"""Plain float32 reference of the latent-diffusion networks the benchmark
runs: the CLIP text transformer, the LDM UNet (SD1 and SD2 forms) and the
KL-VAE, as functions over a flat LDM-named state dict.

It follows the LDM / OpenCLIP layer equations at the widths of a
configuration file (portbench/configs/*.json), with plain torch operations
only: no kernel, no cache, no batching trick. Activations are NHWC at the
public functions (the layout the program hands over) and NCHW inside.
Departures from the published networks, each kept because the program
under test (and the JAX package it ports) makes the same choice:

  * the GELU of SD2's text tower and of every UNet GEGLU is the tanh
    approximation (flax `nn.gelu`), where OpenCLIP and LDM use the erf form;
  * the sinusoidal time embedding is ordered [cos || sin] (LDM's
    `flip_sin_to_cos`).

`quant`, when given, is applied to both operands of every product
(linear, convolution, QK^T and PV): the lower-precision control of the
comparison (reference/quant.py) runs this same code.

Run it with `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` False (`fp32_mode`): a float32 product
on the H100 otherwise runs in TF32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
          "text": "cond_stage_model.model."}
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
# the largest fp32 score block one attention chunk holds
_SCORE_BYTES = 1 << 30


@contextlib.contextmanager
def fp32_mode():
    """Float32 products in float32 (TF32 off) for the scope."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def gn_groups(channels: int, num_groups: int = 32) -> int:
    """The largest divisor of `channels` not above `num_groups`."""
    groups = num_groups
    while channels % groups:
        groups -= 1
    return groups


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class Net:
    """Parameter access and the layer primitives over one network's part of
    a state dict (`prefix`), in float32."""

    def __init__(self, params: Dict[str, torch.Tensor], prefix: str, quant: Quant = None):
        self.p, self.prefix = params, prefix
        self.q = quant or (lambda x: x)

    def w(self, name: str) -> torch.Tensor:
        return self.p[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.p

    def linear(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        """x (..., in) times the (out, in) or (out, in, 1, 1) weight."""
        w = self.w(name + ".weight")
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        return F.linear(self.q(x), self.q(w), self.w(name + ".bias") if bias else None)

    def conv1x1(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """NCHW 1x1 conv as a per-pixel linear map."""
        return self.linear(x.permute(0, 2, 3, 1), name).permute(0, 3, 1, 2)

    def conv3x3(self, x: torch.Tensor, name: str, stride: int = 1,
                pad: Tuple[int, int, int, int] = (1, 1, 1, 1)) -> torch.Tensor:
        """NCHW 3x3 conv after zero padding (left, right, top, bottom)."""
        return F.conv2d(self.q(F.pad(x, pad)), self.q(self.w(name + ".weight")),
                        self.w(name + ".bias"), stride=stride)

    def group_norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.group_norm(x, gn_groups(x.shape[1]), self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)

    def layer_norm(self, x: torch.Tensor, name: str, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """softmax(q k^T / sqrt(d) + mask) v on (B, N, heads * d), in row
        blocks that keep the fp32 scores near _SCORE_BYTES."""
        b, nq, c = q.shape
        nk, d = k.shape[1], c // heads
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)  # noqa: E731
        qh, kh, vh = split(q), split(k), split(v)
        rows = max(1, _SCORE_BYTES // (heads * nq * nk * 4))
        out = []
        for i in range(0, b, rows):
            s = torch.matmul(self.q(qh[i:i + rows]), self.q(kh[i:i + rows]).transpose(-1, -2))
            s = s * d ** -0.5
            if mask is not None:
                s = s + mask
            out.append(torch.matmul(self.q(torch.softmax(s, dim=-1)), self.q(vh[i:i + rows])))
        return torch.cat(out).transpose(1, 2).reshape(b, nq, c)


# ---- CLIP text transformer ----------------------------------------------


def text_encoder(params: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
                 quant: Quant = None) -> torch.Tensor:
    """token ids (B, L) -> the final-LayerNorm sequence (B, L, width)."""
    n = Net(params, PREFIX["text"], quant)
    ids = tokens.long().clamp(0, cfg["vocab_size"] - 1)
    x = n.w("token_embedding.weight")[ids]
    length = x.shape[1]
    x = x + n.w("positional_embedding")[:length]
    mask = torch.full((length, length), float("-inf"), device=x.device).triu(1)
    width, heads = cfg["width"], cfg["heads"]
    for i in range(cfg["layers"]):
        blk = f"transformer.resblocks.{i}."
        y = n.layer_norm(x, blk + "ln_1")
        w = n.w(blk + "attn.in_proj_weight")
        qkv = F.linear(n.q(y), n.q(w), n.w(blk + "attn.in_proj_bias"))
        q, k, v = qkv.split(width, dim=-1)
        x = x + n.linear(n.attention(q, k, v, heads, mask), blk + "attn.out_proj")
        h = n.linear(n.layer_norm(x, blk + "ln_2"), blk + "mlp.c_fc")
        h = h * torch.sigmoid(1.702 * h) if cfg["act"] == "quick_gelu" else gelu_tanh(h)
        x = x + n.linear(h, blk + "mlp.c_proj")
    return n.layer_norm(x, "ln_final")


# ---- UNet ------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unet_layout(cfg: dict) -> Tuple[List[List[tuple]], List[tuple], List[List[tuple]]]:
    """The UNet's blocks as lists of layers: ("res", in, out), ("attn", ch),
    ("down", ch), ("up", ch), ("conv_in", in, out); input blocks, middle
    block, output blocks, in LDM order."""
    mc, ds = cfg["model_channels"], 1
    inputs: List[List[tuple]] = [[("conv_in", cfg["in_channels"], mc)]]
    chans, ch = [mc], mc
    for level, mult in enumerate(cfg["channel_mult"]):
        for _ in range(cfg["num_res_blocks"]):
            block = [("res", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                block.append(("attn", ch))
            inputs.append(block)
            chans.append(ch)
        if level != len(cfg["channel_mult"]) - 1:
            inputs.append([("down", ch)])
            chans.append(ch)
            ds *= 2
    middle = [("res", ch, ch), ("attn", ch), ("res", ch, ch)]
    outputs: List[List[tuple]] = []
    for level, mult in reversed(list(enumerate(cfg["channel_mult"]))):
        for i in range(cfg["num_res_blocks"] + 1):
            block = [("res", ch + chans.pop(), mult * mc)]
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                block.append(("attn", ch))
            if level and i == cfg["num_res_blocks"]:
                ds //= 2
                block.append(("up", ch))
            outputs.append(block)
    return inputs, middle, outputs


def head_split(cfg: dict, ch: int) -> Tuple[int, int]:
    if cfg["num_head_channels"] == -1:
        return cfg["num_heads"], ch // cfg["num_heads"]
    return ch // cfg["num_head_channels"], cfg["num_head_channels"]


def _res_block(n: Net, name: str, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    h = n.conv3x3(F.silu(n.group_norm(x, name + "in_layers.0", 1e-5)), name + "in_layers.2")
    h = h + n.linear(F.silu(emb), name + "emb_layers.1")[:, :, None, None]
    h = n.conv3x3(F.silu(n.group_norm(h, name + "out_layers.0", 1e-5)), name + "out_layers.3")
    if n.has(name + "skip_connection.weight"):
        x = n.conv1x1(x, name + "skip_connection")
    return x + h


def _transformer(n: Net, name: str, cfg: dict, x: torch.Tensor,
                 context: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = x.shape
    heads, _ = head_split(cfg, c)
    t = n.group_norm(x, name + "norm", 1e-6).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    t = n.linear(t, name + "proj_in")
    for d in range(cfg["transformer_depth"]):
        blk = f"{name}transformer_blocks.{d}."
        y = n.layer_norm(t, blk + "norm1")
        a = blk + "attn1."
        t = t + n.linear(n.attention(n.linear(y, a + "to_q", False), n.linear(y, a + "to_k", False),
                                     n.linear(y, a + "to_v", False), heads), a + "to_out.0")
        y = n.layer_norm(t, blk + "norm2")
        a = blk + "attn2."
        t = t + n.linear(n.attention(n.linear(y, a + "to_q", False),
                                     n.linear(context, a + "to_k", False),
                                     n.linear(context, a + "to_v", False), heads), a + "to_out.0")
        h, gate = n.linear(n.layer_norm(t, blk + "norm3"), blk + "ff.net.0.proj").chunk(2, dim=-1)
        t = t + n.linear(h * gelu_tanh(gate), blk + "ff.net.2")
    t = n.linear(t, name + "proj_out")
    return t.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def unet(params: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, t: torch.Tensor,
         context: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """eps (B, H, W, out) of latents x (B, H, W, in), timesteps t (B,) or (1,),
    context (B, L, context_dim)."""
    n = Net(params, PREFIX["unet"], quant)
    emb = timestep_embedding(t.reshape(-1), cfg["model_channels"])
    emb = n.linear(F.silu(n.linear(emb, "time_embed.0")), "time_embed.2")
    emb = emb.expand(x.shape[0], -1) if emb.shape[0] == 1 else emb
    inputs, middle, outputs = unet_layout(cfg)

    def run(block: List[tuple], name: str, h: torch.Tensor) -> torch.Tensor:
        for j, layer in enumerate(block):
            sub = f"{name}{j}."
            if layer[0] == "conv_in":
                h = n.conv3x3(h, sub[:-1])
            elif layer[0] == "res":
                h = _res_block(n, sub, h, emb)
            elif layer[0] == "attn":
                h = _transformer(n, sub, cfg, h, context)
            elif layer[0] == "down":
                h = n.conv3x3(h, sub + "op", stride=2)
            else:
                h = n.conv3x3(F.interpolate(h, scale_factor=2, mode="nearest"), sub + "conv")
        return h

    h = x.float().permute(0, 3, 1, 2)
    hs = []
    for i, block in enumerate(inputs):
        h = run(block, f"input_blocks.{i}.", h)
        hs.append(h)
    h = run(middle, "middle_block.", h)
    for i, block in enumerate(outputs):
        h = run(block, f"output_blocks.{i}.", torch.cat([h, hs.pop()], dim=1))
    h = n.conv3x3(F.silu(n.group_norm(h, "out.0", 1e-5)), "out.2")
    return h.permute(0, 2, 3, 1)


# ---- KL-VAE ----------------------------------------------------------------


def _vae_res(n: Net, name: str, x: torch.Tensor) -> torch.Tensor:
    h = n.conv3x3(F.silu(n.group_norm(x, name + "norm1", 1e-6)), name + "conv1")
    h = n.conv3x3(F.silu(n.group_norm(h, name + "norm2", 1e-6)), name + "conv2")
    if n.has(name + "nin_shortcut.weight"):
        x = n.conv1x1(x, name + "nin_shortcut")
    return x + h


def _vae_attn(n: Net, name: str, x: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = x.shape
    y = n.group_norm(x, name + "norm", 1e-6).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    out = n.attention(n.linear(y, name + "q"), n.linear(y, name + "k"), n.linear(y, name + "v"), 1)
    return x + n.linear(out, name + "proj_out").reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _vae_mid(n: Net, name: str, h: torch.Tensor) -> torch.Tensor:
    h = _vae_res(n, name + "block_1.", h)
    return _vae_res(n, name + "block_2.", _vae_attn(n, name + "attn_1.", h))


def vae_decode(params: Dict[str, torch.Tensor], cfg: dict, z: torch.Tensor,
               quant: Quant = None) -> torch.Tensor:
    """Unscaled latent (B, h, w, embed_dim) -> image (B, H, W, 3), about [-1, 1]."""
    n = Net(params, PREFIX["vae"], quant)
    h = n.conv1x1(z.float().permute(0, 3, 1, 2), "post_quant_conv")
    h = _vae_mid(n, "decoder.mid.", n.conv3x3(h, "decoder.conv_in"))
    for level in reversed(range(len(cfg["ch_mult"]))):
        for j in range(cfg["num_res_blocks"] + 1):
            h = _vae_res(n, f"decoder.up.{level}.block.{j}.", h)
        if level:
            h = n.conv3x3(F.interpolate(h, scale_factor=2, mode="nearest"),
                          f"decoder.up.{level}.upsample.conv")
    h = n.conv3x3(F.silu(n.group_norm(h, "decoder.norm_out", 1e-6)), "decoder.conv_out")
    return h.permute(0, 2, 3, 1)


def vae_encode(params: Dict[str, torch.Tensor], cfg: dict, image: torch.Tensor,
               quant: Quant = None) -> torch.Tensor:
    """Image (B, H, W, 3) in [-1, 1] -> moments (B, h, w, 2 embed_dim)."""
    n = Net(params, PREFIX["vae"], quant)
    h = n.conv3x3(image.float().permute(0, 3, 1, 2), "encoder.conv_in")
    for level in range(len(cfg["ch_mult"])):
        for j in range(cfg["num_res_blocks"]):
            h = _vae_res(n, f"encoder.down.{level}.block.{j}.", h)
        if level != len(cfg["ch_mult"]) - 1:
            h = n.conv3x3(h, f"encoder.down.{level}.downsample.conv", stride=2, pad=(0, 1, 0, 1))
    h = _vae_mid(n, "encoder.mid.", h)
    h = n.conv3x3(F.silu(n.group_norm(h, "encoder.norm_out", 1e-6)), "encoder.conv_out")
    return n.conv1x1(h, "quant_conv").permute(0, 2, 3, 1)


def posterior_sample(moments: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) eps, logvar clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps
