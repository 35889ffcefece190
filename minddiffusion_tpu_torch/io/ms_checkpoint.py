"""MindSpore `.ckpt` reader + name adapter (no mindspore dependency): a
copy of minddiffusion_tpu/io/ms_checkpoint.py, kept here because the port
imports nothing of the JAX package (its io/__init__ pulls in orbax).

The reference ecosystem publishes weights as MindSpore checkpoints (e.g.
`wukong-huahua-ms.ckpt`, stablediffusionv2 README download links). The format
is a bare protobuf:

    message Checkpoint { repeated Value value = 1; }
    message Value     { string tag = 1; TensorProto tensor = 2; }
    message TensorProto { repeated int64 dims = 1; string tensor_type = 2;
                          bytes tensor_content = 3; }

This module hand-decodes that wire format (varints + length-delimited fields —
~80 lines, no proto compiler) and maps MindSpore parameter naming to the
torch/LDM naming that SDModels.load_state_dict consumes:

  * norm params: `.gamma` / `.beta` -> `.weight` / `.bias`
  * embeddings: `.embedding_table` -> `.weight`
  * the MS text-encoder module tree (reference text_encoder.py:25-153:
    `transformer.transformer_layer.resblocks.{i}.attn.attn.in_proj...`)
    -> OpenCLIP naming (`transformer.resblocks.{i}.attn.in_proj_weight`).

Layouts need no transposing here: MindSpore Dense is (out, in) and Conv2d is
OIHW, identical to torch and to the port's modules.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_DTYPES = {
    "Float32": np.dtype("<f4"),
    "Float16": np.dtype("<f2"),
    "Float64": np.dtype("<f8"),
    "Int8": np.dtype("<i1"),
    "Int16": np.dtype("<i2"),
    "Int32": np.dtype("<i4"),
    "Int64": np.dtype("<i8"),
    "UInt8": np.dtype("<u1"),
    "Bool": np.dtype("?"),
}


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


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:  # 64-bit
            val = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> np.ndarray:
    dims = []
    dtype_name = "Float32"
    content = b""
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif field == 2:
            dtype_name = val.decode()
        elif field == 3:
            content = val
    if dtype_name == "BFloat16":
        raw = np.frombuffer(content, dtype="<u2")
        arr = (raw.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(content, dtype=_DTYPES[dtype_name])
    return arr.reshape(dims).astype(np.float32, copy=False)


def load_ms_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Parse a MindSpore .ckpt into {param_name: fp32 numpy array}."""
    with open(path, "rb") as f:
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):
        if field != 1 or wire != 2:
            continue
        tag, tensor = None, None
        for f2, w2, v2 in _fields(val):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2:
                tensor = _parse_tensor(v2)
        if tag is not None and tensor is not None:
            out[tag] = tensor
    return out


def save_ms_checkpoint(path: str, params: Dict[str, np.ndarray]) -> None:
    """Write the same format (round-trip/testing + exporting back to the
    reference ecosystem)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    blob = b""
    for name, arr in params.items():
        arr = np.ascontiguousarray(arr)
        dtype_name = {v: k for k, v in _DTYPES.items()}[np.dtype(arr.dtype.newbyteorder("<"))]
        tensor = b""
        for d in arr.shape:
            tensor += varint(1 << 3) + varint(d)
        tensor += ld(2, dtype_name.encode())
        tensor += ld(3, arr.tobytes())
        value = ld(1, name.encode()) + ld(2, tensor)
        blob += ld(1, value)
    with open(path, "wb") as f:
        f.write(blob)


_TEXT_RENAMES = [
    (".transformer_layer.resblocks.", ".transformer.resblocks."),
    (".attn.attn.in_proj.weight", ".attn.in_proj_weight"),
    (".attn.attn.in_proj.bias", ".attn.in_proj_bias"),
    (".attn.attn.out_proj.", ".attn.out_proj."),
]


def ms_to_ldm_names(ms_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """MindSpore param names -> torch/LDM names (for convert_sd_checkpoint)."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in ms_dict.items():
        if "cond_stage_model" in name:
            # MS: cond_stage_model.transformer.<...>; OpenCLIP expects
            # cond_stage_model.model.<...> with renamed leaves
            name = name.replace("cond_stage_model.transformer.",
                                "cond_stage_model.model.")
            name = name.replace(".embedding_table", ".token_embedding.weight")
            for old, new in _TEXT_RENAMES:
                name = name.replace(old, new)
            # MS SequentialCell mlp names: resblocks.{i}.c_fc / .c_proj
            if ".mlp." not in name:
                name = name.replace(".c_fc.", ".mlp.c_fc.")
                name = name.replace(".c_proj.", ".mlp.c_proj.")
        name = name.replace(".gamma", ".weight").replace(".beta", ".bias")
        name = name.replace(".embedding_table", ".weight")
        out[name] = arr
    return out
