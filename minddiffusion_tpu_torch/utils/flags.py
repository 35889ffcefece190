"""The port's copy of five flags of minddiffusion_tpu/utils/flags.py.

    MDT_WINO=0          opt out of the Winograd conv kernels entirely: every
                        3x3 conv takes the non-Winograd route (no K2 or K3
                        launch, no Winograd transform U computed); any
                        other value leaves them on
    MDT_CFG_DEDUP=0     opt out of CFG-prefix dedup: by default the SD
                        txt2img and img2img pipelines run the UNet prefix
                        (everything before the first cross-attention) once
                        at batch B instead of on the duplicated 2B batch
    MDT_HOIST=...       "1" (the default) or "force": keep the sampling
                        run's constants from their first call on: the
                        cross-attention K/V of the text context (SD's
                        `to_k` / `to_v`, GLIDE's `encoder_kv`) and the
                        Winograd transforms U of the conv weights (SD and
                        GLIDE); "0": none of them; or a comma list of
                        "kv" and "wino": "kv" keeps the K/V, "wino" GLIDE's
                        U (SD keeps its U under every value but "0", as in
                        the JAX package); "wino" alone drops the K/V
    MDT_WINO_TUNE=...   comma k=v conv-kernel tuning: hmax=<int>, cmin=<int>
                        (the Winograd shape gate's ceiling on min(H, W) and
                        floor on C_in), dma=0 (the gathered-tile kernel K3
                        instead of K2, which reads its own halo), chain=0
    MDT_GLIDE_TUNE=...  comma k=v GLIDE tuning: attn_route=<int> (GLIDE's
                        attention sites take the packed kernel K1 from this
                        many query and key tokens on, instead of the
                        1024 / 512 gates)

The JAX package hoists through a capture pass before its sampler's scan,
which it runs only on a TPU unless MDT_HOIST=force (an XLA constant
matter). The port keeps its constants in caches that the pipelines open for
one sampling run (models/layers.hoisted), so "1" and "force" both hoist, on
every device. One default differs on purpose: under "1" the port's GLIDE
keeps its Winograd U cache, which the JAX package turned off on a TPU
measurement.

`chain` is accepted with the JAX package's grammar and switches nothing:
merged resblock chaining is a TPU-only rewrite the port does not have. The
JAX package's GLIDE keys `s2d` (the space-to-depth SRGAN tail) and
`skip_join` (the split / barrier skip joins) raise: those TPU-only
rewrites are not in the port either.

The snapshot is rebuilt only when one of the variables changes, so a
sampling loop sees one constant object while tests that monkeypatch a
variable see their change. Model code reads `flags()`, never the
environment.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

_KEYS = ("MDT_WINO_TUNE", "MDT_GLIDE_TUNE", "MDT_CFG_DEDUP", "MDT_HOIST", "MDT_WINO")


@dataclasses.dataclass(frozen=True)
class Flags:
    wino: bool = True
    wino_dma: bool = True
    wino_chain: bool = True
    wino_hmax: Optional[int] = None
    wino_cmin: Optional[int] = None
    glide_attn_route: Optional[int] = None
    cfg_dedup: bool = True
    hoist: bool = True              # SD's Winograd U cache; False only under "0"
    hoist_kv: bool = True
    hoist_wino_glide: bool = True


def _entries(raw: str, var: str, keys: str, example: str):
    """(key, value) of each k=v entry of `raw`; a malformed one raises a
    ValueError naming the syntax, as the JAX package's does."""
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"{var} entry {part!r}: expected k=v with k in "
                             f"{{{keys}}} (e.g. '{example}')")
        k, v = part.split("=", 1)
        yield k.strip(), v.strip()


def parse_wino_tune(raw: str) -> dict:
    """'hmax=64,cmin=320,dma=0,chain=0' -> field overrides."""
    out: dict = {}
    for k, v in _entries(raw, "MDT_WINO_TUNE", "hmax,cmin,dma,chain",
                         "hmax=64,cmin=320,dma=0"):
        if k in ("hmax", "cmin"):
            out[f"wino_{k}"] = int(v)
        elif k == "dma":
            out["wino_dma"] = v != "0"
        elif k == "chain":
            out["wino_chain"] = v != "0"
        else:
            raise ValueError(f"MDT_WINO_TUNE key {k!r}: expected one of "
                             "hmax/cmin/dma/chain")
    return out


def parse_glide_tune(raw: str) -> dict:
    """'attn_route=256' -> field overrides."""
    out: dict = {}
    for k, v in _entries(raw, "MDT_GLIDE_TUNE", "attn_route", "attn_route=256"):
        if k == "attn_route":
            out["glide_attn_route"] = int(v)
        elif k in ("s2d", "skip_join"):
            raise ValueError(f"MDT_GLIDE_TUNE key {k!r}: the port has no such rewrite "
                             "(the SRGAN space-to-depth tail and the split / barrier "
                             "skip joins are TPU-only); only attn_route is accepted")
        else:
            raise ValueError(f"MDT_GLIDE_TUNE key {k!r}: expected attn_route")
    return out


def parse_hoist(raw: str) -> dict:
    """MDT_HOIST -> field overrides; unset or empty is the default "1"."""
    raw = raw.strip()
    if raw in ("", "1", "force"):
        return {}
    if raw == "0":
        return dict(hoist=False, hoist_kv=False, hoist_wino_glide=False)
    parts = {p.strip() for p in raw.split(",")}
    if not parts <= {"kv", "wino"}:
        raise ValueError(f"MDT_HOIST {raw!r}: expected 1, 0, force or a comma list "
                         "of kv and wino (e.g. 'kv' or 'kv,wino')")
    return dict(hoist_kv="kv" in parts, hoist_wino_glide="wino" in parts)


def parse_cfg_dedup(raw: str) -> dict:
    """MDT_CFG_DEDUP -> field overrides: "0" opts out, anything else is on."""
    return dict(cfg_dedup=raw != "0")


def parse_wino(raw: str) -> dict:
    """MDT_WINO -> field overrides: "0" opts out, anything else is on."""
    return dict(wino=raw != "0")


_cache: Tuple[Optional[tuple], Flags] = (None, Flags())


def flags() -> Flags:
    """The current flag snapshot (rebuilt only when a variable changed)."""
    global _cache
    key = tuple(os.environ.get(k, "") for k in _KEYS)
    if _cache[0] != key:
        _cache = (key, Flags(**parse_wino_tune(key[0]), **parse_glide_tune(key[1]),
                             **parse_cfg_dedup(key[2]), **parse_hoist(key[3]),
                             **parse_wino(key[4])))
    return _cache[1]
