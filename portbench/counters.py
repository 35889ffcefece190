"""The program's own counters that the benchmark reads: the launch counts
of its kernel wrappers (`.launches`)."""
from __future__ import annotations

from typing import Dict


def launches() -> Dict[str, int]:
    from minddiffusion_tpu_torch.ops import flash_attention as fa
    from minddiffusion_tpu_torch.ops import winograd as wg

    return {"K1": fa.flash_attention_packed.launches, "K4": fa.flash_attention.launches,
            "K2": wg.conv3x3_winograd.launches, "K3": wg.conv3x3_winograd_gathered.launches}


def per(before: Dict[str, int], after: Dict[str, int], n: int) -> Dict[str, float]:
    return {k: (after[k] - before[k]) / n for k in after} if n else {}
