"""The port's copy of the Winograd tuning flag of minddiffusion_tpu/utils/flags.py.

    MDT_WINO_TUNE=...   comma k=v conv-kernel tuning: hmax=<int>, cmin=<int>
                        (the Winograd shape gate's ceiling on min(H, W) and
                        floor on C_in), dma=0 (the gathered-tile kernel K3
                        instead of K2, which reads its own halo), chain=0

`chain` is accepted with the JAX package's grammar and switches nothing:
merged resblock chaining is a TPU-only rewrite the port does not have.

The snapshot is rebuilt only when MDT_WINO_TUNE changes, so a sampling loop
sees one constant object while tests that monkeypatch the variable see
their change. Model code reads `flags()`, never the environment.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Flags:
    wino_dma: bool = True
    wino_chain: bool = True
    wino_hmax: Optional[int] = None
    wino_cmin: Optional[int] = None


def parse_wino_tune(raw: str) -> dict:
    """'hmax=64,cmin=320,dma=0,chain=0' -> field overrides; a malformed entry
    raises a ValueError naming the syntax, as the JAX package's does."""
    out: dict = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"MDT_WINO_TUNE entry {part!r}: expected k=v with k in "
                "{hmax,cmin,dma,chain} (e.g. 'hmax=64,cmin=320,dma=0')")
        k, v = part.split("=", 1)
        k = k.strip()
        if k in ("hmax", "cmin"):
            out[f"wino_{k}"] = int(v)
        elif k == "dma":
            out["wino_dma"] = v.strip() != "0"
        elif k == "chain":
            out["wino_chain"] = v.strip() != "0"
        else:
            raise ValueError(
                f"MDT_WINO_TUNE key {k!r}: expected one of "
                "hmax/cmin/dma/chain")
    return out


_cache: Tuple[Optional[str], Flags] = (None, Flags())


def flags() -> Flags:
    """The current flag snapshot (rebuilt only when MDT_WINO_TUNE changed)."""
    global _cache
    raw = os.environ.get("MDT_WINO_TUNE", "")
    if _cache[0] != raw:
        _cache = (raw, Flags(**parse_wino_tune(raw)))
    return _cache[1]
