"""JAX-package SD params -> the port's LDM-named state dict, without JAX.

`state_dict_from_jax` is a numpy port of minddiffusion_tpu/io/sd_weights.py
`export_sd_checkpoint` (its unet/vae/clip translators and `_invert`): it
takes the JAX package's {unet, vae, text} param trees as nested dicts of
numpy arrays and returns flat LDM names (`model.diffusion_model.*`,
`first_stage_model.*`, `cond_stage_model.model.*`) with torch layouts:

  flax conv  (kh, kw, I, O) -> torch conv   (O, I, kh, kw)
  flax dense (I, O)         -> torch linear (O, I)
  norm scale/bias           -> weight/bias
  LoRA {base/kernel, lora_a (I, r), lora_b (r, O)} -> weight (O, I),
       lora_a, lora_b (kept as they are)

The port's modules carry exactly these names, so
`SDModels.load_state_dict` loads the result with strict=True.

Also here: the safetensors reader and writer (a copy of the JAX codec,
with BF16 read and written through torch, so no JAX-side bfloat16 package
is needed) and
`export_sd_checkpoint`, the port models' LDM state dict.
"""
from __future__ import annotations

import json
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
            "text": "cond_stage_model.model."}

Entry = Optional[Tuple[str, str]]   # (LDM name, layout kind) or unmapped


def _leaf(leaf: str, name: str, kind: str) -> Tuple[str, str]:
    """flax leaf kernel/scale/bias -> LDM weight/bias, with its layout kind."""
    if leaf == "kernel":
        return name + ".weight", kind
    if leaf == "scale":
        return name + ".weight", "ident"
    return name + ".bias", "ident"


def _to_torch(x: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(x, (3, 2, 0, 1))
    if kind == "dense":
        return np.transpose(x)
    return np.asarray(x)


_RES = {"norm_in": ("in_layers.0", "ident"), "conv_in": ("in_layers.2", "conv"),
        "emb_proj": ("emb_layers.1", "dense"), "norm_out": ("out_layers.0", "ident"),
        "conv_out": ("out_layers.3", "conv"), "skip": ("skip_connection", "conv")}


def _transformer(parts, leaf, use_linear: bool) -> Entry:
    head, rest = parts[0], parts[1:]
    if head == "norm":
        return _leaf(leaf, "norm", "ident")
    if head in ("proj_in", "proj_out"):         # dense (SD2) or 1x1 conv (SD1)
        return _leaf(leaf, head, "dense" if use_linear else "conv")
    if head.startswith("block_"):
        base = f"transformer_blocks.{head[len('block_'):]}"
        inner = rest[0]
        if inner in ("attn1", "attn2"):
            proj = rest[1]
            # a LoRADense site: {base: {kernel[, bias]}, lora_a, lora_b}
            if rest[2:] not in ([], ["base"]) or proj not in ("to_q", "to_k", "to_v",
                                                             "to_out"):
                return None
            name = f"{base}.{inner}.{'to_out.0' if proj == 'to_out' else proj}"
            if leaf in ("lora_a", "lora_b"):
                return f"{name}.{leaf}", "ident"
            return _leaf(leaf, name, "dense")
        if inner in ("norm1", "norm2", "norm3"):
            return _leaf(leaf, f"{base}.{inner}", "ident")
        if inner == "ff":
            sub = {"geglu": "ff.net.0.proj", "proj_out": "ff.net.2"}.get(rest[1])
            if sub:
                return _leaf(leaf, f"{base}.{sub}", "dense")
    return None


def unet_translator(config) -> Callable[[Tuple[str, ...]], Entry]:
    """JAX UNet param path -> LDM name under model.diffusion_model."""
    nrb, mult = config.num_res_blocks, config.channel_mult
    use_linear = config.use_linear_in_transformer
    attn_res = set(config.attention_resolutions)
    in_idx, n, ds = {}, 1, 1
    for level in range(len(mult)):
        for i in range(nrb):
            in_idx[("res", level, i)] = n
            n += 1
        if level != len(mult) - 1:
            in_idx[("ds", level)] = n
            n += 1
            ds *= 2
    out_idx, up_slot, n = {}, {}, 0
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            out_idx[(level, i)] = n
            if level and i == nrb:
                up_slot[level] = 2 if ds in attn_res else 1
            n += 1
        if level:
            ds //= 2
    top = {"in_conv": ("input_blocks.0.0", "conv"),
           "time_embed_0": ("time_embed.0", "dense"),
           "time_embed_2": ("time_embed.2", "dense"),
           "out_norm": ("out.0", "ident"), "out_conv": ("out.2", "conv")}

    def translate(path: Tuple[str, ...]) -> Entry:
        parts = list(path)
        leaf = parts.pop()
        head = parts.pop(0)
        if head in top:
            return _leaf(leaf, *top[head])
        if head == "label_emb" and leaf == "embedding":    # nn.Embed (num_classes, 4 mc)
            return "label_emb.weight", "ident"

        def res_leaf(base):
            m = _RES.get(parts[0])
            if m is None or (parts[0].startswith("norm")
                             and parts[1:2] != ["GroupNorm_0"]):
                return None
            return _leaf(leaf, f"{base}.{m[0]}", m[1])

        def attn_leaf(base):
            r = _transformer(parts, leaf, use_linear)
            return None if r is None else (f"{base}.{r[0]}", r[1])

        if head in ("mid_res1", "mid_attn", "mid_res2"):
            base = f"middle_block.{('mid_res1', 'mid_attn', 'mid_res2').index(head)}"
            return attn_leaf(base) if head == "mid_attn" else res_leaf(base)
        bits = head.split("_")
        if bits[0] == "down":
            if bits[-1] == "ds":
                return _leaf(leaf, f"input_blocks.{in_idx[('ds', int(bits[1]))]}.0.op",
                             "conv")
            nn_ = in_idx[("res", int(bits[1]), int(bits[2]))]
        elif bits[0] == "up":
            if bits[-1] == "us":
                level = int(bits[1])
                return _leaf(leaf, f"output_blocks.{out_idx[(level, nrb)]}."
                             f"{up_slot[level]}.conv", "conv")
            nn_ = out_idx[(int(bits[1]), int(bits[2]))]
        else:
            return None
        kind, blocks = bits[3], "input_blocks" if bits[0] == "down" else "output_blocks"
        if kind == "res":
            return res_leaf(f"{blocks}.{nn_}.0")
        if kind == "attn":
            return attn_leaf(f"{blocks}.{nn_}.1")
        return None

    return translate


def vae_translator(path: Tuple[str, ...]) -> Entry:
    """JAX AutoencoderKL param path -> LDM name under first_stage_model."""
    parts = list(path)
    leaf = parts.pop()
    top = parts.pop(0)
    if top in ("quant_conv", "post_quant_conv"):
        return _leaf(leaf, top, "conv")
    if top not in ("encoder", "decoder"):
        return None
    head = parts.pop(0)
    if head in ("conv_in", "conv_out"):
        return _leaf(leaf, f"{top}.{head}", "conv")
    if head == "norm_out":
        return _leaf(leaf, f"{top}.norm_out", "ident")

    def block(base):
        sub = parts[0]
        if sub in ("norm1", "norm2"):
            return _leaf(leaf, f"{base}.{sub}", "ident")
        if sub in ("conv1", "conv2", "nin_shortcut"):
            return _leaf(leaf, f"{base}.{sub}", "conv")
        return None

    if head in ("mid_block_1", "mid_block_2"):
        return block(f"{top}.mid.block_{head[-1]}")
    if head == "mid_attn":
        sub = parts[0]
        if sub == "norm":
            return _leaf(leaf, f"{top}.mid.attn_1.norm", "ident")
        if sub in ("q", "k", "v", "proj_out"):
            return _leaf(leaf, f"{top}.mid.attn_1.{sub}", "conv")
        return None
    bits = head.split("_")
    if bits[2] == "block":
        return block(f"{top}.{bits[0]}.{bits[1]}.block.{bits[3]}")
    if bits[2] in ("downsample", "upsample"):
        return _leaf(leaf, f"{top}.{bits[0]}.{bits[1]}.{bits[2]}.conv", "conv")
    return None


def clip_translator(path: Tuple[str, ...]) -> Entry:
    """JAX CLIPTextEncoder param path -> OpenCLIP name under cond_stage_model.model."""
    parts = list(path)
    leaf = parts.pop()
    head = parts.pop(0) if parts else leaf
    if head in ("token_embedding", "positional_embedding"):
        return ("token_embedding.weight" if head == "token_embedding"
                else "positional_embedding"), "ident"
    if head == "ln_final":
        return _leaf(leaf, "ln_final", "ident")
    if head.startswith("resblock_"):
        base = f"transformer.resblocks.{head[len('resblock_'):]}"
        sub = parts.pop(0)
        if sub == "attn":
            proj = parts.pop(0)
            if proj == "qkv":
                return (f"{base}.attn.in_proj_weight", "dense") if leaf == "kernel" \
                    else (f"{base}.attn.in_proj_bias", "ident")
            if proj == "out_proj":
                return _leaf(leaf, f"{base}.attn.out_proj", "dense")
        if sub in ("ln_1", "ln_2"):
            return _leaf(leaf, f"{base}.{sub}", "ident")
        if sub in ("mlp_fc", "mlp_proj"):
            return _leaf(leaf, f"{base}.mlp.{'c_fc' if sub == 'mlp_fc' else 'c_proj'}",
                         "dense")
    return None


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = v
    return flat


def state_dict_from_jax(params: dict, unet_config) -> Dict[str, np.ndarray]:
    """{unet, vae, text} JAX param trees (numpy leaves) -> flat LDM state
    dict of float32 numpy arrays. Raises on a leaf with no LDM name."""
    translators = {"unet": unet_translator(unet_config), "vae": vae_translator,
                   "text": clip_translator}
    out: Dict[str, np.ndarray] = {}
    for kind, translate in translators.items():
        if kind not in params:
            continue
        for path, leaf in _flatten(params[kind]).items():
            if path and path[0] == "params":
                path = path[1:]
            entry = translate(path)
            if entry is None:
                raise KeyError(f"no LDM name for {kind}/{'/'.join(path)}")
            name, layout = entry
            out[PREFIXES[kind] + name] = _to_torch(np.asarray(leaf, np.float32), layout)
    return out


# ---------------------------------------------------------------------------
# safetensors (JAX io/sd_weights.py `load_safetensors` / `save_safetensors`)
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {  # numpy dtype -> safetensors name; BF16 goes through torch
    np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL",
}
_SAFETENSORS_TO_NUMPY = {v: k for k, v in _SAFETENSORS_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file (8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}}, the row-major tensor
    bytes) into numpy arrays, float tensors as fp32, as the JAX reader
    returns them. BF16 is decoded through a torch view of its bytes."""
    import torch

    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        a, b = spec["data_offsets"]
        if spec["dtype"] == "BF16":
            t = torch.frombuffer(bytearray(data[a:b]), dtype=torch.bfloat16)
            out[name] = t.float().numpy().reshape(spec["shape"])
            continue
        if spec["dtype"] not in _SAFETENSORS_TO_NUMPY:
            raise KeyError(f"unsupported safetensors dtype {spec['dtype']!r}")
        dt = _SAFETENSORS_TO_NUMPY[spec["dtype"]]
        arr = np.frombuffer(data[a:b], dtype=dt).reshape(spec["shape"])
        out[name] = arr.astype(np.float32) if np.issubdtype(dt, np.floating) else arr.copy()
    return out


def save_safetensors(state_dict: Dict, path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays or torch tensors (bf16 ones as BF16) in the
    safetensors layout, names sorted, as the JAX writer does."""
    import torch

    header: Dict = {"__metadata__": metadata} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(state_dict):
        value = state_dict[name]
        if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
            kind, raw = "BF16", value.detach().cpu().contiguous().view(torch.int16).numpy()
        else:
            raw = np.ascontiguousarray(value.detach().cpu().numpy()
                                       if isinstance(value, torch.Tensor) else value)
            if raw.dtype not in _SAFETENSORS_DTYPES:
                raise ValueError(f"unsupported dtype {raw.dtype} for {name}")
            kind = _SAFETENSORS_DTYPES[raw.dtype]
        header[name] = {"dtype": kind, "shape": list(raw.shape),
                        "data_offsets": [offset, offset + raw.nbytes]}
        offset += raw.nbytes
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw.tobytes())


def export_sd_checkpoint(models) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """`SDModels` -> (the LDM-named fp32 state dict with its LDM prefixes,
    report). LoRA adapters have no LDM name: they are reported and left out
    (merge them first with `models.lora.merge_lora_state_dict`), as the JAX
    `export_sd_checkpoint` reports its unmapped leaves."""
    from minddiffusion_tpu_torch.models.lora import is_lora_name

    out: Dict[str, np.ndarray] = {}
    report: List[str] = []
    for name, value in models.state_dict().items():
        if is_lora_name(name):
            report.append(f"not exported: {name}")
            continue
        out[name] = value.detach().float().cpu().numpy()
    return out, report
