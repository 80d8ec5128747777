"""Step timing, device profiling hooks and the port's spans.

Counterpart of ``fedicra_tpu/utils/profiling.py``:

- ``StepTimer``: a wall-clock accumulator with percentile summaries; with
  ``block_on`` it waits for the card before it stops the clock;
- ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host ops and, with a card, its kernels) into a directory;
- ``annotate(name, **ids)``: the port's one span. It is on exactly while a
  ``torch.profiler`` session records, and otherwise returns at once. On, it
  opens a ``record_function`` (the span on the profiler's host timeline),
  records a CUDA event at each end on the current stream once the process
  uses the card, and appends a record to this module's table when it closes;
- ``HostSyncs``: counts the synchronising CUDA operations of a block while a
  session records, each against the innermost open span;
- ``count(counter)``: one count of ``counter`` against the innermost open
  span while a session records (the sharded round's ``collectives``);
- ``spans()``, ``counters()``, ``reset()``: read and empty that table. A
  span's device milliseconds are read from its events only here, so the
  spans never synchronise the work they time.

Spans nest across threads: the table keeps one stack of open spans, so a
span opened on the autograd engine's thread while the caller waits in
``backward()`` takes the caller's open span as its parent.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


def _cuda_devices(block_on) -> set:
    """The CUDA devices of the tensors in ``block_on`` (nested lists, tuples
    and dicts), or ``block_on`` itself when it is a device."""
    if isinstance(block_on, torch.device):
        return {block_on} if block_on.type == "cuda" else set()
    if isinstance(block_on, torch.Tensor):
        return {block_on.device} if block_on.is_cuda else set()
    if isinstance(block_on, dict):
        block_on = list(block_on.values())
    if isinstance(block_on, (list, tuple)):
        return set().union(*(_cuda_devices(b) for b in block_on)) if block_on else set()
    return set()


class StepTimer:
    def __init__(self):
        self._durations: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """Time the block; ``block_on`` (tensors or a device) names the cards
        to synchronise before the clock stops, as JAX blocks on arrays."""
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(block_on):
            torch.cuda.synchronize(device)
        self._durations[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._durations[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._durations.items():
            a = np.asarray(vals)
            out[name] = {
                "count": int(a.size),
                "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)),
                "total_s": float(a.sum()),
            }
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the card's kernels too when
    there is one) and write ``trace_<pid>_<ns>.json``, a Chrome trace, into
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


# ---- spans and counters -----------------------------------------------------

# the message of ``torch.cuda.set_sync_debug_mode("warn")``'s warnings
SYNC_WARNING = "called a synchronizing CUDA operation"

_lock = threading.Lock()
_open: List["_Span"] = []  # innermost last; one stack for every thread
_done: List["_Span"] = []
_counts: Dict[str, Dict[Optional[str], int]] = {}
_seq = itertools.count()
_OFF = contextlib.nullcontext()


def _recording() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "ids", "seq", "parent", "t0", "t1", "events", "device_ms", "_rf")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        with _lock:
            outer = _open[-1] if _open else None
            self.seq = next(_seq)
            self.parent = None if outer is None else outer.seq
            if outer is not None:
                self.ids = {**outer.ids, **self.ids}
            _open.append(self)
        self.events = None
        self.device_ms = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        with _lock:
            _open.remove(self)
            _done.append(self)
        self._rf.__exit__(*exc)
        return False


def annotate(name: str, **ids):
    """A span called ``name`` around the block, with ``ids`` (and its open
    parent's) in its record; nothing at all unless a profiler records."""
    if not _recording():
        return _OFF
    return _Span(name, ids)


def spans() -> List[dict]:
    """The finished spans, in the order they closed: ``name``, ``seq`` (the
    span's number), ``parent`` (the enclosing span's ``seq``, or None),
    ``ids``, ``host_s`` (``perf_counter`` at its start and end) and
    ``device_ms`` (from its CUDA events; None without the card). Reading
    waits for the spans' end events."""
    with _lock:
        done = list(_done)
    out = []
    for s in done:
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
        out.append({"name": s.name, "seq": s.seq, "parent": s.parent, "ids": dict(s.ids),
                    "host_s": (s.t0, s.t1), "device_ms": s.device_ms})
    return out


def counters() -> Dict[str, Dict[Optional[str], int]]:
    """Each counter's counts by the innermost open span's name (None: no
    span was open); a counter that ran and counted nothing maps to {}."""
    with _lock:
        return {name: dict(by_span) for name, by_span in _counts.items()}


def reset() -> None:
    """Empty the table of finished spans and counts."""
    with _lock:
        _done.clear()
        _counts.clear()


def _count(counter: str) -> None:
    with _lock:
        by_span = _counts.setdefault(counter, {})
        span = _open[-1].name if _open else None
        by_span[span] = by_span.get(span, 0) + 1


def count(counter: str) -> None:
    """Count one ``counter`` against the innermost open span, while a
    profiler records; otherwise nothing."""
    if _recording():
        _count(counter)


class HostSyncs:
    """``with HostSyncs(device) as syncs:`` counts the block's synchronising
    CUDA operations (``torch.cuda.set_sync_debug_mode("warn")``, whose
    warnings are counted as ``counters()["host_syncs"]`` and swallowed),
    those of the autograd engine's threads included, while a profiler
    records on a CUDA ``device``; ``with syncs.paused():`` leaves a part of
    the block out. Otherwise it does nothing. The previous debug mode and
    warning handlers come back on exit."""

    counter = "host_syncs"

    def __init__(self, device):
        self.on = _recording() and torch.device(device).type == "cuda"

    def __enter__(self):
        if self.on:
            self._prev = torch.cuda.get_sync_debug_mode()
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self._show = warnings.showwarning
            warnings.showwarning = self._show_or_count
            with _lock:
                _counts.setdefault(self.counter, {})
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(self._prev)
            self._warnings.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def paused(self):
        if not self.on:
            yield
            return
        torch.cuda.set_sync_debug_mode(self._prev)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def _show_or_count(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            _count(self.counter)
        else:
            self._show(message, category, filename, lineno, file, line)
