#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(``benchmark/configs/<config>.json``, whose ``precision`` names
``benchmark/precisions/<precision>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/drivers/<kind>.py``); ``benchmark/limits/<cell>.json`` holds
the limit of each number the driver's check compares. With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``benchmark/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``: each compared number beside its limit, which also
end standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result; it exits 3 and prints no result
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"


def load_cell(workload: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "cell": cell,
        "config": config,
        "precision": json.loads((BENCH / "precisions" / f"{config['precision']}.json").read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{workload}.json").read_text())["limits"],
        "end_to_end": [m["name"] for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m["name"] for m in spec["per_layer"] if applies(m)],
    }


def driver(kind: str):
    """The module ``benchmark/drivers/<kind>.py``: ``run``, ``compare`` and
    the readings the tools take limits from."""
    if not (BENCH / "drivers" / f"{kind}.py").is_file():
        raise SystemExit(f"no driver benchmark/drivers/{kind}.py for traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` (as ``load_cell`` gives it) on ``device``: the
    result line's keys, ``device`` aside."""
    from benchmark.harness import env, readers

    kind = cell["traffic"]["kind"]
    env.set_precision(cell["precision"])
    metric_readers = {name: readers.load(name) for name in cell["per_layer"]} if trace else {}
    out = driver(kind).run(cell, seed, seconds, trace, device, t_start, metric_readers)
    produced = out.pop("end_to_end")
    missing = [m for m in cell["end_to_end"] if m not in produced]
    if missing:
        raise SystemExit(f"the {kind} driver does not measure {missing}")
    chosen = out.pop("per_layer", {}) if trace else {m: produced[m] for m in cell["end_to_end"]}
    out["metrics"] = {name: {"value": v, "unit": u} for name, (v, u) in chosen.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    cell = load_cell(args.workload)
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                        "memory_peak_bytes": int(result.pop("memory_peak_bytes"))}
    if args.trace:
        result["device"]["busy_s"] = result.pop("busy_s")
        result["device"]["window_s"] = result.pop("window_s")
    checks = result.pop("checks")
    result["checks"] = checks  # last in the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
