"""The traced segment of a `--trace 1` run and its reduction.

`Segment` runs `torch.profiler` with CUDA activity alone (the device's
operations and the host's CUDA runtime calls; recording every host
operator as well made a Wukong batch a third slower, against 7% for
this) around a stretch of the window, whose ends it takes from the host's
wall clock, the profiler's timebase. `reduce_events` turns the profile
into plain records: every device operation (kernel, copy, set) inside the
segment, the union of their intervals (busy_s) against the segment's
length (window_s), the device operations that took the most time and the
longest idle gaps, each gap named by the runtime call the host was in
when it began ("host: no runtime call" where it was in Python).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

TOP = 10


def _name(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of [start, end) intervals, sorted."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                  window: Tuple[int, int]) -> dict:
    """device / host: (name, start_ns, end_ns); window: (start_ns, end_ns)."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = merge([(s, e) for _, s, e in dev if e > s])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, int] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:TOP]:
        running = [(s, n) for n, s, e in host if s <= g0 < e]
        named.append([_name(max(running)[1]) if running else "host: no runtime call",
                      (g1 - g0) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device": [(n, s, e) for n, s, e in dev],
            "breakdown": {"device_ops": [[_name(n), ns / 1e9] for n, ns in top],
                          "idle_gaps": named}}


class Segment:
    """with Segment() as seg: ...  seg.result is the reduction, or None where
    the profiler recorded no segment. The segment ends after a synchronise
    (`sync_inside`: the caller's work is all in it), or, for an open loop
    whose work goes on, where the scope ends, the device then drained
    before the profiler stops so that every operation in it is recorded."""

    def __init__(self, sync_inside: bool = True):
        self.result: Optional[dict] = None
        self.sync_inside = sync_inside

    def __enter__(self) -> "Segment":
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        # without a card (the tests) the host's operators stand in
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._w0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        cuda = torch.cuda.is_available()
        if self.sync_inside and cuda:
            torch.cuda.synchronize()
        w1 = time.time_ns()
        if cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce_profile(self._prof, (self._w0, w1))


def reduce_profile(prof, window: Tuple[int, int]) -> dict:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        (device if e.device_type() == DeviceType.CUDA else host).append(rec)
    return reduce_events(device, host, window)
