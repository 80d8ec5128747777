"""Step timing and device profiling hooks.

Counterpart of ``fedicra_tpu/utils/profiling.py``:

- ``StepTimer``: a wall-clock accumulator with percentile summaries; with
  ``block_on`` it waits for the card before it stops the clock;
- ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host ops and, with a card, its kernels) into a directory;
- ``annotate()``: a named span (``record_function``) in that trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

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


def annotate(name: str):
    """A named span in the profile (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
