"""The reduction of a ``torch.profiler`` trace to what the metrics read.

A trace is reduced to two lists of (name, start_us, end_us): the device's
activity (kernels, copies, sets) and the host spans (the benchmark's own
``record_function`` spans and the port's and PyTorch's host ops). The idle
arithmetic is copied from ``tools/profile_torch_round.py``: the device is
busy over the union of its intervals, since cuDNN may run kernels on more
than one stream. Kernel families come from ``kernel_families.json``, first
match wins.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]
SPAN_PREFIX = "bench."  # the benchmark's own spans

FAMILIES = [(f["family"], tuple(f["substrings"]))
            for f in json.loads((Path(__file__).with_name("kernel_families.json")).read_text())]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def matches(name: str, include: Sequence[str], exclude: Sequence[str] = ()) -> bool:
    low = name.lower()
    return any(k in low for k in include) and not any(k in low for k in exclude)


def _bounds_us(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        return ev.start_ns() / 1e3, ev.end_ns() / 1e3
    return float(ev.start_us()), float(ev.start_us() + ev.duration_us())


def reduce_profile(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) of a finished ``torch.profiler.profile``."""
    import torch

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = _bounds_us(ev)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((ev.name(), start, end))
        elif not (hasattr(ev, "is_user_annotation") and ev.is_user_annotation()):
            # a span's copy on the device's timeline is no device work
            device.append((ev.name(), start, end))
    return device, host


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy + (0.0 if cur_end is None else cur_end - cur_start)


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in intervals if e > lo and s < hi]


def gaps(device: Sequence[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no device interval runs."""
    out, cur = [], lo
    for _, s, e in sorted(device, key=lambda t: t[1]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def innermost(host: Sequence[Interval], t: float, prefix: Optional[str] = None) -> Optional[str]:
    """The shortest host interval that holds time ``t`` (of those whose
    name starts with ``prefix``, if given)."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (prefix is None or name.startswith(prefix)):
            if best is None or e - s < best[1]:
                best = (name, e - s)
    return None if best is None else best[0]


def summarise(device: Sequence[Interval], host: Sequence[Interval], window: Tuple[float, float],
              span_prefix: str = SPAN_PREFIX, top: int = 10) -> Dict:
    """What a traced window gives every reader: the device's busy and
    window seconds, kernel time by name and by family, and the breakdown
    (the families that took most time; the longest idle gaps, each named
    by the benchmark's innermost span around it and the host op running)."""
    lo, hi = window
    dev = clip([d for d in device if not d[0].startswith(span_prefix)], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) / 1e6
    by_family: Dict[str, float] = defaultdict(float)
    for name, sec in by_name.items():
        by_family[family(name)] += sec
    idle = []
    inner_host = [h for h in host if not h[0].startswith(span_prefix)]
    for s, e in sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        span = innermost(host, mid, span_prefix) or "outside"
        op = innermost(inner_host, mid) or "no host op"
        idle.append((f"{span} | {op}", (e - s) / 1e6))
    return {
        "busy_s": union_us([(s, e) for _, s, e in dev]) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "by_name": dict(by_name),
        "by_family": dict(by_family),
        "breakdown": {
            "device_ops": [[f, s] for f, s in sorted(by_family.items(), key=lambda t: -t[1])[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]],
        },
    }


def span_window(host: Sequence[Interval], name: str) -> Tuple[float, float]:
    """The (start, end) of the host span called ``name``."""
    for n, s, e in host:
        if n == name:
            return s, e
    raise LookupError(f"no span {name!r} in the trace")
