"""The yardstick of the roofline and peak shares: the card's data-sheet
peaks (peaks.json), the least time of a piece of work, and the device
time the trace attributes to an operation's kernels."""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Optional

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_seconds(flops: float = 0.0, exps: float = 0.0, nbytes: float = 0.0) -> float:
    """The largest of the bf16 tensor-core time, the exp time and the HBM
    time of the work."""
    return max(flops / PEAKS["bf16_flops_per_s"], exps / PEAKS["fp32_exp_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def kernel_seconds(trace: Optional[dict], patterns: List[str]) -> Optional[float]:
    """Device seconds of the traced operations whose name matches a pattern
    (a regular expression searched in the name); None where none does."""
    if not trace or not patterns:
        return None
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    total = sum(e - s for name, s, e in trace["device"] if rx.search(name))
    return total / 1e9 if total > 0 else None


def share(least: float, seconds: Optional[float]) -> Optional[float]:
    """100 x least / seconds, in %; None without a measured time."""
    if not seconds or least <= 0:
        return None
    return 100.0 * least / seconds
