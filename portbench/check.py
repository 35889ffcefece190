"""Numbers of the comparison with the plain reference, and their limits."""
from __future__ import annotations

from typing import Dict, List

import torch


def row_rel(got: torch.Tensor, ref: torch.Tensor, center: float = 0.0) -> float:
    """The largest over rows (the leading axis) of ||got - ref|| / ||ref - center||."""
    g = got.double().reshape(got.shape[0], -1)
    r = ref.double().reshape(ref.shape[0], -1).to(g.device)
    num = torch.linalg.vector_norm(g - r, dim=1)
    den = torch.linalg.vector_norm(r - center, dim=1).clamp(min=1e-30)
    return float((num / den).max())


def limited(numbers: Dict[str, float], limits: Dict[str, float]) -> List[tuple]:
    """(name, value, limit) for every number the cell holds a limit for;
    a number without one is an error in the cell's file."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit in the cell's file for {missing}")
    return [(k, numbers[k], float(limits[k])) for k in sorted(numbers)]

