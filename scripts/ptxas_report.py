"""Print ptxas's report (registers, shared memory, spills per kernel) for one
of the port's CUDA sources, and count the tensor-core instructions in its
SASS, per kernel and in all: HGMMA (Hopper's wgmma) and HMMA (mma.sync).

    python3 scripts/ptxas_report.py winograd [more names] [--root DIR]

A name is csrc/<name>.cu's (e.g. `fused_ff`, K5's; `glide_tail`, K9's;
`gn_stats`, K6's), or `packed` for K1's
packed_attention.cu, or `flash` for K4's flash_attention.cu. Each kernel's line reads "SASS lines
with HGMMA n, HMMA m; registers r, spills s" (s: the bytes of its spill
stores and loads). Compiles minddiffusion_tpu_torch/ops/csrc/<name>.cu with
the flags of `ops/_build.py` plus `-Xptxas -v` into a temporary directory;
`--root DIR` takes the sources of the checkout under DIR instead (e.g. the
parent commit's, unpacked by `git archive`), so two commits' registers are
compared with one toolkit. Needs the CUDA toolkit (nvcc, cuobjdump), no
card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from minddiffusion_tpu_torch.ops import _build  # noqa: E402


ALIASES = {"packed": "packed_attention", "flash": "flash_attention"}


def report(name: str, csrc: Path = _build.CSRC) -> None:
    name = ALIASES.get(name, name)
    nvcc = _build.nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, f"lib{name}.so")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                               str(csrc / f"{name}.cu")],
                              capture_output=True, text=True, check=True)
        lines = [ln for ln in proc.stderr.splitlines() if ln.strip()]
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
    print(f"== {name}.cu: ptxas -v ({csrc})")
    print("\n".join(lines))
    regs = ptxas_usage(lines)
    for fn, (hgmma, hmma) in sass_counts(sass).items():
        r, spill = regs.get(fn, ("?", "?"))
        print(f"== {name}.cu: {fn}: SASS lines with HGMMA {hgmma}, HMMA {hmma}; "
              f"registers {r}, spills {spill}")
    counts = {op: sum(f" {op}" in ln for ln in sass.splitlines()) for op in ("HGMMA", "HMMA")}
    print(f"== {name}.cu: SASS lines with HGMMA {counts['HGMMA']}, HMMA {counts['HMMA']}")


def ptxas_usage(lines) -> dict:
    """{kernel (mangled name): (registers, bytes of spill stores + loads)}
    from ptxas -v's lines: "Compiling entry function 'f'", then "Function
    properties for f" with its spill line, then "Used r registers"."""
    usage, fn = {}, None
    for ln in lines:
        m = re.search(r"(?:entry function '|Function properties for )([^' ]+)", ln)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, [None, 0])
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            usage[fn][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def sass_counts(sass: str) -> dict:
    """{kernel (mangled name): (HGMMA lines, HMMA lines)} of cuobjdump -sass
    output, each kernel's code starting at its "Function : " line."""
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += " HGMMA" in ln
            counts[fn][1] += " HMMA" in ln
    return {k: tuple(v) for k, v in counts.items()}


if __name__ == "__main__":
    args = sys.argv[1:]
    csrc = _build.CSRC
    if "--root" in args:
        i = args.index("--root")
        csrc = Path(args[i + 1]).resolve() / "minddiffusion_tpu_torch" / "ops" / "csrc"
        del args[i:i + 2]
    for n in args or ["winograd"]:
        report(n, csrc)
