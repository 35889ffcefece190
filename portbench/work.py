"""The layers of a configuration's networks as work records, counted from
the configuration file's shapes alone (never from the program's route):

    ("conv3x3", rows, h_out, w_out, c_in, c_out, stride, net)
    ("linear", rows * tokens, n_in, n_out, net)        (1x1 convs included)
    ("attn", rows, heads, n_q, n_k, d, kind, net)      kind "self" / "cross"

`unet` takes `rows` for the guidance-folded batch and `prefix_rows` for
the layers before the first cross-attention, which a sampler with the
CFG-prefix saving runs once for both halves (the least work of the step).
"""
from __future__ import annotations

from typing import Iterator, Optional

from portbench.reference.models import head_split, unet_layout

Work = tuple


def _res(rows, h, w, c_in, c_out, emb, net) -> Iterator[Work]:
    yield ("conv3x3", rows, h, w, c_in, c_out, 1, net)
    yield ("linear", rows, emb, c_out, net)
    yield ("conv3x3", rows, h, w, c_out, c_out, 1, net)
    if c_in != c_out:
        yield ("linear", rows * h * w, c_in, c_out, net)


def _transformer(cfg, rows, prefix_rows, h, w, ch, ctx_len, cross_kv, net) -> Iterator[Work]:
    heads, d = head_split(cfg, ch)
    inner, n = heads * d, h * w
    yield ("linear", prefix_rows * n, ch, inner, net)
    for _ in range(cfg["transformer_depth"]):
        yield ("linear", prefix_rows * n, inner, 3 * inner, net)
        yield ("attn", prefix_rows, heads, n, n, d, "self", net)
        yield ("linear", prefix_rows * n, inner, inner, net)
        prefix_rows = rows
        yield ("linear", rows * n, inner, inner, net)
        if cross_kv:
            yield ("linear", rows * ctx_len, cfg["context_dim"], 2 * inner, net)
        yield ("attn", rows, heads, n, ctx_len, d, "cross", net)
        yield ("linear", rows * n, inner, inner, net)
        yield ("linear", rows * n, inner, 8 * inner, net)
        yield ("linear", rows * n, 4 * inner, inner, net)
    yield ("linear", rows * n, inner, ch, net)


def unet(cfg: dict, rows: int, h: int, w: int, ctx_len: int,
         prefix_rows: Optional[int] = None, cross_kv: bool = True) -> Iterator[Work]:
    """One evaluation at latent h x w. `cross_kv` False: the cross-attention
    K/V of a constant context, computed once for a sampling run, are not
    counted again."""
    r = rows if prefix_rows is None else prefix_rows
    mc = cfg["model_channels"]
    yield ("linear", 1, mc, 4 * mc, "unet")
    yield ("linear", 1, 4 * mc, 4 * mc, "unet")
    inputs, middle, outputs = unet_layout(cfg)
    scale = 1
    blocks = [("in", b) for b in inputs] + [("mid", middle)] + [("out", b) for b in outputs]
    for _, block in blocks:
        for layer in block:
            hh, ww = h // scale, w // scale
            if layer[0] == "conv_in":
                yield ("conv3x3", r, hh, ww, layer[1], layer[2], 1, "unet")
            elif layer[0] == "res":
                yield from _res(r, hh, ww, layer[1], layer[2], 4 * mc, "unet")
            elif layer[0] == "attn":
                yield from _transformer(cfg, rows, r, hh, ww, layer[1], ctx_len, cross_kv,
                                        "unet")
                r = rows
            elif layer[0] == "down":
                scale *= 2
                yield ("conv3x3", r, h // scale, w // scale, layer[1], layer[1], 2, "unet")
            else:
                scale //= 2
                yield ("conv3x3", r, h // scale, w // scale, layer[1], layer[1], 1, "unet")
    yield ("conv3x3", rows, h, w, mc, cfg["out_channels"], 1, "unet")


def _vae_res(rows, h, w, c_in, c_out, net) -> Iterator[Work]:
    yield ("conv3x3", rows, h, w, c_in, c_out, 1, net)
    yield ("conv3x3", rows, h, w, c_out, c_out, 1, net)
    if c_in != c_out:
        yield ("linear", rows * h * w, c_in, c_out, net)


def _vae_mid(rows, h, w, c, net) -> Iterator[Work]:
    yield from _vae_res(rows, h, w, c, c, net)
    yield ("linear", rows * h * w, c, 4 * c, net)       # q, k, v and proj_out
    yield ("attn", rows, 1, h * w, h * w, c, "self", net)
    yield from _vae_res(rows, h, w, c, c, net)


def vae_decode(cfg: dict, rows: int, h: int, w: int) -> Iterator[Work]:
    """Latent h x w -> image; the decoder and post_quant_conv."""
    ch, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    net = "vae_decode"
    yield ("linear", rows * h * w, cfg["embed_dim"], cfg["z_channels"], net)
    c = ch * mult[-1]
    yield ("conv3x3", rows, h, w, cfg["z_channels"], c, 1, net)
    yield from _vae_mid(rows, h, w, c, net)
    for level in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            yield from _vae_res(rows, h, w, c, ch * mult[level], net)
            c = ch * mult[level]
        if level:
            h, w = 2 * h, 2 * w
            yield ("conv3x3", rows, h, w, c, c, 1, net)
    yield ("conv3x3", rows, h, w, c, cfg["out_channels"], 1, net)


def vae_encode(cfg: dict, rows: int, h: int, w: int) -> Iterator[Work]:
    """Image h x w -> moments; the encoder and quant_conv."""
    ch, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    net = "vae_encode"
    yield ("conv3x3", rows, h, w, cfg["in_channels"], ch, 1, net)
    c = ch
    for level, m in enumerate(mult):
        for _ in range(nrb):
            yield from _vae_res(rows, h, w, c, ch * m, net)
            c = ch * m
        if level != len(mult) - 1:
            h, w = h // 2, w // 2
            yield ("conv3x3", rows, h, w, c, c, 2, net)
    yield from _vae_mid(rows, h, w, c, net)
    yield ("conv3x3", rows, h, w, c, 2 * cfg["z_channels"], 1, net)
    yield ("linear", rows * h * w, 2 * cfg["z_channels"], 2 * cfg["embed_dim"], net)


def text(cfg: dict, rows: int) -> Iterator[Work]:
    wd, n = cfg["width"], cfg["context_length"]
    for _ in range(cfg["layers"]):
        yield ("linear", rows * n, wd, 4 * wd, "text")            # q, k, v, out
        yield ("attn", rows, cfg["heads"], n, n, wd // cfg["heads"], "self", "text")
        yield ("linear", rows * n, wd, 8 * wd, "text")            # c_fc, c_proj


def flops(rec: Work) -> float:
    """Multiply-adds x 2 of a record, the direct algorithm."""
    if rec[0] == "conv3x3":
        _, rows, h, w, ci, co, _, _ = rec
        return 2.0 * 9 * rows * h * w * ci * co
    if rec[0] == "linear":
        _, m, n_in, n_out, _ = rec
        return 2.0 * m * n_in * n_out
    _, rows, heads, nq, nk, d, _, _ = rec
    return 4.0 * rows * heads * nq * nk * d


def txt2img_batch(config: dict, traffic: dict) -> Iterator[Work]:
    """One txt2img batch: text at the guidance-folded batch, every UNet
    evaluation (the prefix once for both halves, the cross-attention K/V
    once for the run), the VAE decode."""
    b = traffic["batch"]
    f = 2 ** (len(config["vae"]["ch_mult"]) - 1)
    h, w = traffic["height"] // f, traffic["width"] // f
    yield from text(config["text"], 2 * b)
    for i in range(traffic["steps"]):
        yield from unet(config["unet"], 2 * b, h, w, config["text"]["context_length"], b,
                        cross_kv=i == 0)
    yield from vae_decode(config["vae"], b, h, w)


def train_sample(config: dict, traffic: dict) -> Iterator[Work]:
    """One training sample: VAE encode, text forward, the UNet's forward
    and its backward (twice the forward's work)."""
    f = 2 ** (len(config["vae"]["ch_mult"]) - 1)
    size = traffic["image_size"]
    yield from vae_encode(config["vae"], 1, size, size)
    yield from text(config["text"], 1)
    for _ in range(3):
        yield from unet(config["unet"], 1, size // f, size // f, config["text"]["context_length"])
