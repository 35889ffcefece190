"""The LDM-named parameters of a configuration, with their shapes and their
kind, enumerated from the configuration file alone: what the benchmark
draws its seeded weights from (portbench/weights.py).

Kinds: "w" (a matrix or a conv kernel), "b" (a bias), "norm_w" / "norm_b"
(a GroupNorm or LayerNorm scale / shift), "emb" (the token embedding),
"pos" (the positional embedding).
"""
from __future__ import annotations

from typing import Iterator, Tuple

from portbench.reference.models import PREFIX, head_split, unet_layout

Param = Tuple[str, Tuple[int, ...], str]


def _norm(name: str, ch: int) -> Iterator[Param]:
    yield name + ".weight", (ch,), "norm_w"
    yield name + ".bias", (ch,), "norm_b"


def _lin(name: str, n_out: int, n_in: int, bias: bool = True, conv1x1: bool = False
         ) -> Iterator[Param]:
    yield name + ".weight", (n_out, n_in, 1, 1) if conv1x1 else (n_out, n_in), "w"
    if bias:
        yield name + ".bias", (n_out,), "b"


def _conv(name: str, n_out: int, n_in: int) -> Iterator[Param]:
    yield name + ".weight", (n_out, n_in, 3, 3), "w"
    yield name + ".bias", (n_out,), "b"


def text_params(cfg: dict) -> Iterator[Param]:
    w = cfg["width"]
    yield "token_embedding.weight", (cfg["vocab_size"], w), "emb"
    yield "positional_embedding", (cfg["context_length"], w), "pos"
    for i in range(cfg["layers"]):
        blk = f"transformer.resblocks.{i}."
        yield from _norm(blk + "ln_1", w)
        yield blk + "attn.in_proj_weight", (3 * w, w), "w"
        yield blk + "attn.in_proj_bias", (3 * w,), "b"
        yield from _lin(blk + "attn.out_proj", w, w)
        yield from _norm(blk + "ln_2", w)
        yield from _lin(blk + "mlp.c_fc", 4 * w, w)
        yield from _lin(blk + "mlp.c_proj", w, 4 * w)
    yield from _norm("ln_final", w)


def _res(name: str, n_in: int, n_out: int, emb: int) -> Iterator[Param]:
    yield from _norm(name + "in_layers.0", n_in)
    yield from _conv(name + "in_layers.2", n_out, n_in)
    yield from _lin(name + "emb_layers.1", n_out, emb)
    yield from _norm(name + "out_layers.0", n_out)
    yield from _conv(name + "out_layers.3", n_out, n_out)
    if n_in != n_out:
        yield from _lin(name + "skip_connection", n_out, n_in, conv1x1=True)


def _transformer(name: str, cfg: dict, ch: int) -> Iterator[Param]:
    heads, d = head_split(cfg, ch)
    inner = heads * d
    conv = not cfg["use_linear_in_transformer"]
    yield from _norm(name + "norm", ch)
    yield from _lin(name + "proj_in", inner, ch, conv1x1=conv)
    for i in range(cfg["transformer_depth"]):
        blk = f"{name}transformer_blocks.{i}."
        for a, ctx in (("attn1.", inner), ("attn2.", cfg["context_dim"])):
            yield from _lin(blk + a + "to_q", inner, inner, bias=False)
            yield from _lin(blk + a + "to_k", inner, ctx, bias=False)
            yield from _lin(blk + a + "to_v", inner, ctx, bias=False)
            yield from _lin(blk + a + "to_out.0", inner, inner)
        yield from _lin(blk + "ff.net.0.proj", 8 * inner, inner)
        yield from _lin(blk + "ff.net.2", inner, 4 * inner)
        for k in (1, 2, 3):
            yield from _norm(f"{blk}norm{k}", inner)
    yield from _lin(name + "proj_out", ch, inner, conv1x1=conv)


def unet_params(cfg: dict) -> Iterator[Param]:
    mc = cfg["model_channels"]
    emb = 4 * mc
    yield from _lin("time_embed.0", emb, mc)
    yield from _lin("time_embed.2", emb, emb)
    inputs, middle, outputs = unet_layout(cfg)
    blocks = [(f"input_blocks.{i}.", b) for i, b in enumerate(inputs)]
    blocks += [("middle_block.", middle)]
    blocks += [(f"output_blocks.{i}.", b) for i, b in enumerate(outputs)]
    for name, block in blocks:
        for j, layer in enumerate(block):
            sub = f"{name}{j}."
            if layer[0] == "conv_in":
                yield from _conv(sub[:-1], layer[2], layer[1])
            elif layer[0] == "res":
                yield from _res(sub, layer[1], layer[2], emb)
            elif layer[0] == "attn":
                yield from _transformer(sub, cfg, layer[1])
            else:
                yield from _conv(sub + ("op" if layer[0] == "down" else "conv"),
                                 layer[1], layer[1])
    yield from _norm("out.0", mc)
    yield from _conv("out.2", cfg["out_channels"], mc)


def _vae_res(name: str, n_in: int, n_out: int) -> Iterator[Param]:
    yield from _norm(name + "norm1", n_in)
    yield from _conv(name + "conv1", n_out, n_in)
    yield from _norm(name + "norm2", n_out)
    yield from _conv(name + "conv2", n_out, n_out)
    if n_in != n_out:
        yield from _lin(name + "nin_shortcut", n_out, n_in, conv1x1=True)


def _vae_mid(name: str, ch: int) -> Iterator[Param]:
    yield from _vae_res(name + "block_1.", ch, ch)
    yield from _norm(name + "attn_1.norm", ch)
    for k in ("q", "k", "v", "proj_out"):
        yield from _lin(f"{name}attn_1.{k}", ch, ch, conv1x1=True)
    yield from _vae_res(name + "block_2.", ch, ch)


def vae_params(cfg: dict) -> Iterator[Param]:
    ch, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    z, e = cfg["z_channels"], cfg["embed_dim"]
    yield from _conv("encoder.conv_in", ch, cfg["in_channels"])
    c = ch
    for level, m in enumerate(mult):
        for j in range(nrb):
            yield from _vae_res(f"encoder.down.{level}.block.{j}.", c, ch * m)
            c = ch * m
        if level != len(mult) - 1:
            yield from _conv(f"encoder.down.{level}.downsample.conv", c, c)
    yield from _vae_mid("encoder.mid.", c)
    yield from _norm("encoder.norm_out", c)
    yield from _conv("encoder.conv_out", 2 * z, c)
    c = ch * mult[-1]
    yield from _conv("decoder.conv_in", c, z)
    yield from _vae_mid("decoder.mid.", c)
    for level in reversed(range(len(mult))):
        for j in range(nrb + 1):
            yield from _vae_res(f"decoder.up.{level}.block.{j}.", c, ch * mult[level])
            c = ch * mult[level]
        if level:
            yield from _conv(f"decoder.up.{level}.upsample.conv", c, c)
    yield from _norm("decoder.norm_out", c)
    yield from _conv("decoder.conv_out", cfg["out_channels"], c)
    yield from _lin("quant_conv", 2 * e, 2 * z, conv1x1=True)
    yield from _lin("post_quant_conv", z, e, conv1x1=True)


def model_params(config: dict) -> Iterator[Param]:
    """Every parameter of a configuration's three networks, LDM-named."""
    for kind, fn in (("unet", unet_params), ("vae", vae_params), ("text", text_params)):
        for name, shape, k in fn(config[kind]):
            yield PREFIX[kind] + name, shape, k
