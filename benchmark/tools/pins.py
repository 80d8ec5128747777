#!/usr/bin/env python3
"""Write a cell's pinned readings: ``benchmark/tests/pins/<cell>.json``.

    python3 benchmark/tools/pins.py --workload <cell>

The reference's readings of client 0's first round on the CPU (seed
2**31 + 977, 32^2, batch 2, 2 threads), each float as its hex: the losses,
each leaf's gradient norm at each phase's first step and each leaf's
change; and ``work.step_flops`` at the cell's own size.
``benchmark/tests/test_bench_work.py`` holds every cell of
``BENCHMARK.json`` to its file bit for bit.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PINS = ROOT / "benchmark" / "tests" / "pins"
SEED = 2**31 + 977  # beyond 32 signed bits, as the check's seeds are
IMG, BATCH, THREADS = 32, 2, 2


def path(workload: str) -> Path:
    return PINS / f"{workload}.json"


def readings(workload: str) -> dict:
    """The cell's pins: its reference readings at ``IMG``^2 and ``BATCH``
    on ``THREADS`` CPU threads, and its step FLOPs at its own size."""
    import torch

    from benchmark.harness import work
    from benchmark.reference import models
    from benchmark.run import driver, load_cell

    cell = load_cell(workload)
    small = copy.deepcopy(cell["config"])
    small["task"]["img_size"], small["train"]["batch_size"] = IMG, BATCH
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        ref = driver(cell["traffic"]["kind"]).reference_readings(small, cell["traffic"], SEED, "cpu")
    finally:
        torch.set_num_threads(before)
    config = cell["config"]
    return {"losses": [x.hex() for x in ref["losses"]],
            "grads": {str(j): {n: v.hex() for n, v in sorted(g.items())} for j, g in sorted(ref["grads"].items())},
            "change": {n: v.hex() for n, v in sorted(ref["change"].items())},
            "step_flops": work.step_flops(models.load(config["model"]), config)}


def render(pins: dict) -> str:
    return json.dumps(pins, indent=1) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = path(args.workload)
    out.write_text(render(readings(args.workload)))
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
