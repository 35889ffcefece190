"""What the benchmark finds by name, and the rules every run keeps.

    configs/<config>.json     a model configuration: widths, dtype, source
    workloads/<cell>.json     a cell: its configuration, traffic mix, chips,
                              metrics and the limits of its comparison
    traffic/<mix>.json        a traffic mix: its kind and parameters
    traffic/<kind>.py         the generator and runner of one kind
    metrics/<metric>.py       UNIT, SOURCE and read(records) -> number or None
    ops/<operation>.py        the operations and bytes of one step, from shapes
    ops/<operation>.kernels,  the kernel-name patterns the device trace
    ops/<operation>.*.kernels attributes to the operation, one a line

A later cell, mix, metric or kernel route is a new file here; no file that
exists is edited for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "minddiffusion_tpu")
_modules: Dict[Path, ModuleType] = {}


def load_json(kind: str, name: str, base: Path = BENCH) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """A benchmark file imported by its path (names may hold dots)."""
    path = path.resolve()
    if path not in _modules:
        if not path.is_file():
            raise FileNotFoundError(path)
        name = "portbench._byname." + path.relative_to(BENCH).with_suffix("").as_posix() \
            .replace("/", ".").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]


def metric(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py")


def operation(name: str) -> ModuleType:
    return load_module(BENCH / "ops" / f"{name}.py")


def kernel_patterns(name: str) -> List[str]:
    """The patterns of ops/<name>.kernels and every ops/<name>.*.kernels."""
    files = [BENCH / "ops" / f"{name}.kernels"] + sorted((BENCH / "ops").glob(f"{name}.*.kernels"))
    out = []
    for f in files:
        if f.is_file():
            out += [s.strip() for s in f.read_text().splitlines()
                    if s.strip() and not s.lstrip().startswith("#")]
    return out


def traffic_kind(kind: str) -> ModuleType:
    return load_module(BENCH / "traffic" / f"{kind}.py")


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.cell.get("chips", 1))

    def metrics(self, trace: bool) -> List[str]:
        return list(self.cell["per_layer" if trace else "end_to_end"])


def resolve(workload: str, base: Path = BENCH) -> Cell:
    cell = load_json("workloads", workload, base)
    return Cell(workload, cell, load_json("configs", cell["config"], base),
                load_json("traffic", cell["traffic"], base))


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed derived from the run's seed and `keys` (ints or strings)."""
    s = int(seed) % (1 << 64)
    words = [s & 0xFFFFFFFF, s >> 32]
    for k in keys:
        words += list(k.encode()) if isinstance(k, str) else [int(k) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind hands back from one run."""

    attempted: int
    failed: int
    records: dict
    checks: List[tuple]                    # (name, value, limit)
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None           # trace.reduce_events of the traced segment

    @property
    def correct(self) -> bool:
        return all(v is not None and v == v and v <= lim for _, v, lim in self.checks)
