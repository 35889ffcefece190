"""Build the hand-written CUDA kernels under csrc/ and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so it compiles with nvcc
alone (no PyTorch headers) in seconds: at first use into `_build/` next to
this file, again whenever the source or a shared `csrc/*.cuh` header is
newer than the library. Nothing is
built when the module is imported; the CPU path never calls `load`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then the default toolkit."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu to _build/lib<name>.so unless it is newer than
    the source and every csrc/*.cuh header."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so; `signatures` maps each C
    function to its argtypes (every function returns a cudaError_t int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def on_device(device):
    """A context that makes `device` the current CUDA device for a launch;
    a no-op (none of torch.cuda.device's calls) when it already is."""
    import contextlib

    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
