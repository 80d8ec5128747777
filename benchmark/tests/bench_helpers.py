"""Shared pieces of the benchmark's CPU tests: the cells as ``run.load_cell``
gives them, cut to a size a CPU test can hold."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def small_cell(name: str, img: int = 32, batch: int = 2) -> dict:
    """The cell ``name`` with its images cut to ``img``^2 and its batch to ``batch``."""
    from benchmark.run import load_cell

    cell = copy.deepcopy(load_cell(name))
    cell["config"]["task"]["img_size"] = img
    cell["config"]["train"]["batch_size"] = batch
    return cell
