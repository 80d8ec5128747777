"""What the program's own spans and counters give the readers.

``fedicra_torch/utils/profiling.py`` keeps a table of the spans the port
emits (``annotate``) and the counts it makes (``HostSyncs``) while a
``torch.profiler`` session records; in a benchmark run that session is the
traced round, so the whole table is that round's. A program without the
table (``spans`` or ``counters`` missing) gives nothing to read.
"""

from __future__ import annotations

from typing import Optional, Sequence


def _table(name: str):
    from fedicra_torch.utils import profiling

    return getattr(profiling, name, None)


def _steps(record: dict) -> Optional[int]:
    tr = record.get("trace")
    return tr["steps"] if tr and tr["steps"] else None


def span_ms_per_step(record: dict, names: Sequence[str]) -> Optional[float]:
    """Device ms a step in the spans called one of ``names``, from their CUDA
    events, over the traced round's steps."""
    steps = _steps(record)
    spans = _table("spans") if steps else None
    if spans is None:
        return None
    ms = [s["device_ms"] for s in spans() if s["name"] in names]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / steps


def count_per_step(record: dict, counter: str) -> Optional[float]:
    """The counter's counts over the traced round's steps (0 where it ran and
    counted nothing)."""
    steps = _steps(record)
    counters = _table("counters") if steps else None
    if counters is None:
        return None
    by_span = counters().get(counter)
    return None if by_span is None else sum(by_span.values()) / steps
