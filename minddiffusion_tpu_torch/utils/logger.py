"""Structured KV training logger + wall-clock profiling contexts (the
port's copy of minddiffusion_tpu/utils/logger.py).

Rebuilt equivalent of the reference's OpenAI-logger port
(Taichu-GLIDE/model/glide_text2im/train/logger.py:36-328): `logkv`,
`logkv_mean`, `dumpkvs` with pluggable Human/JSON/CSV/TensorBoard writers,
rank-0-only by default, plus `profile_kv` context timers. The TensorBoard
writer (reference logger.py:160-198 wraps TF's EventsWriter) emits the
events-file format from scratch — TFRecord framing with masked CRC32C +
hand-encoded Event/Summary protos, zero TF dependency. torch.profiler
traces come from train/loop.py `ProfilerCallback`.

Two faults of the JAX copy are fixed here (F3 in ROADMAP.md): `_varint`
encodes a negative int as protobuf does (two's complement in 64 bits, ten
bytes) instead of looping forever, and the events file name carries the
process id, so two writers started within one second do not share a file.
"""
from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional



class HumanWriter:
    def __init__(self, stream):
        self.stream = stream

    def write(self, kvs: Dict):
        if not kvs:
            return
        items = sorted(kvs.items())
        width = max(len(k) for k, _ in items)
        lines = [f"| {k.ljust(width)} | {_fmt(v)} |" for k, v in items]
        sep = "-" * len(lines[0])
        self.stream.write("\n".join([sep, *lines, sep]) + "\n")
        self.stream.flush()


class JsonWriter:
    def __init__(self, path: str):
        self.f = open(path, "a")

    def write(self, kvs: Dict):
        self.f.write(json.dumps({k: _jsonable(v) for k, v in kvs.items()}) + "\n")
        self.f.flush()


class CsvWriter:
    def __init__(self, path: str):
        self.path = path
        self.keys: list = []

    def write(self, kvs: Dict):
        new_keys = [k for k in kvs if k not in self.keys]
        rows = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                rows = list(csv.DictReader(f))
        if new_keys:
            self.keys.extend(new_keys)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys)
            w.writeheader()
            for row in rows:
                w.writerow(row)
            w.writerow({k: _jsonable(kvs.get(k, "")) for k in self.keys})


# ---- TensorBoard events file, from scratch ---------------------------------
# Format: a TFRecord stream of serialized tensorflow.Event protos. Each
# record is [len: uint64 LE][masked_crc32c(len): uint32 LE][payload]
# [masked_crc32c(payload): uint32 LE]; the mask is TF's
# ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff. The protos we need:
#   Event  { double wall_time = 1; int64 step = 2; Summary summary = 5; }
#   Summary{ repeated Value value = 1; }
#   Value  { string tag = 1; float simple_value = 2; }

_CRC32C_TABLE = []


def _crc32c(data: bytes) -> int:
    if not _CRC32C_TABLE:
        for i in range(256):  # Castagnoli polynomial (reflected 0x82F63B78)
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # a negative int64 as protobuf writes it
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _tb_event(wall_time: float, step: int, kvs: Dict) -> bytes:
    import struct

    values = b""
    for k, v in kvs.items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue  # non-numeric KVs stay in the json/csv streams
        val = (_field(1, 2) + _varint(len(k.encode())) + k.encode()
               + _field(2, 5) + struct.pack("<f", fv))
        values += _field(1, 2) + _varint(len(val)) + val
    event = (_field(1, 1) + struct.pack("<d", wall_time)
             + _field(2, 0) + _varint(step)
             + _field(5, 2) + _varint(len(values)) + values)
    return event


class TensorBoardWriter:
    """Append-only events.out.tfevents writer (numeric KVs only)."""

    def __init__(self, dir_path: str):
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(
            dir_path, f"events.out.tfevents.{int(time.time())}.minddiffusion.{os.getpid()}")
        self.step = 0
        # file-version header event TensorBoard expects first
        self._append(_field(1, 1) + __import__("struct").pack("<d", time.time())
                     + _field(3, 2) + _varint(len(b"brain.Event:2"))
                     + b"brain.Event:2")

    def _append(self, payload: bytes) -> None:
        import struct

        header = struct.pack("<Q", len(payload))
        rec = (header + struct.pack("<I", _masked_crc(header)) + payload
               + struct.pack("<I", _masked_crc(payload)))
        with open(self.path, "ab") as f:
            f.write(rec)

    def write(self, kvs: Dict):
        self.step = int(kvs.get("step", self.step + 1))
        self._append(_tb_event(time.time(), self.step, kvs))


def _fmt(v):
    return f"{v:.5g}" if isinstance(v, float) else str(v)


def _jsonable(v):
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            return str(v)
    return v


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None, formats=("human", "json"),
                 only_primary: bool = True):
        self.kvs: Dict = {}
        self._means: Dict = defaultdict(lambda: [0.0, 0])
        self.writers = []
        self.enabled = not (only_primary and _rank() != 0)
        if not self.enabled:
            return
        import sys

        for fmt in formats:
            if fmt == "human":
                self.writers.append(HumanWriter(sys.stdout))
            elif fmt == "json":
                assert log_dir, "json format needs log_dir"
                os.makedirs(log_dir, exist_ok=True)
                self.writers.append(JsonWriter(os.path.join(log_dir, "log.jsonl")))
            elif fmt == "csv":
                assert log_dir, "csv format needs log_dir"
                os.makedirs(log_dir, exist_ok=True)
                self.writers.append(CsvWriter(os.path.join(log_dir, "progress.csv")))
            elif fmt == "tensorboard":
                assert log_dir, "tensorboard format needs log_dir"
                self.writers.append(TensorBoardWriter(os.path.join(log_dir, "tb")))
            else:
                raise ValueError(f"unknown log format {fmt!r}")

    def logkv(self, key, val):
        self.kvs[key] = val

    def logkv_mean(self, key, val):
        total, count = self._means[key]
        self._means[key] = [total + float(val), count + 1]

    def dumpkvs(self) -> Dict:
        for k, (total, count) in self._means.items():
            self.kvs[k] = total / max(count, 1)
        out = dict(self.kvs)
        if self.enabled:
            for w in self.writers:
                w.write(out)
        self.kvs.clear()
        self._means.clear()
        return out


def _rank() -> int:
    """This process's torch.distributed rank, 0 when not distributed."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


_DEFAULT: Optional[KVLogger] = None


def configure(log_dir: Optional[str] = None, formats=("human", "json")) -> KVLogger:
    global _DEFAULT
    _DEFAULT = KVLogger(log_dir, formats)
    return _DEFAULT


def get_logger() -> KVLogger:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = KVLogger(formats=("human",))
    return _DEFAULT


@contextlib.contextmanager
def profile_kv(name: str, logger: Optional[KVLogger] = None):
    """Accumulate wall-clock into `time/<name>` (reference profile_kv)."""
    t0 = time.time()
    try:
        yield
    finally:
        (logger or get_logger()).logkv_mean(f"time/{name}", time.time() - t0)
