"""Per-layer metric readers, found by name: ``metrics/<metric>.py``.

A reader module has ``UNIT`` and ``read(record) -> float | None``; it
returns None where the run's record holds nothing for it to read, and the
metric is then left out of the result line.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

from .trace import matches

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def load(name: str) -> ModuleType:
    path = METRICS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_ms_per_step(record: dict, include, exclude=()):
    """Device ms a step in kernels whose names match, from the traced round."""
    tr = record.get("trace")
    if not tr or not tr["steps"]:
        return None
    sec = sum(s for name, s in tr["by_name"].items() if matches(name, include, exclude))
    return sec * 1e3 / tr["steps"] if sec > 0 else None
