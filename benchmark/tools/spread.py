#!/usr/bin/env python3
"""Run a cell several times, one process after another, and report the
spread of each metric.

    python3 benchmark/tools/spread.py --workload <cell> --seeds 1,2,3 \
        [--seconds 45] [--trace 0] [--sets 2] [--out chiprun_out/sets.jsonl]

Each run is ``benchmark/run.py`` in a process of its own, as the check runs
it; each set runs the same seeds. For each metric it prints each set's
median and spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--sets", type=int, default=1)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [s for s in args.seeds.split(",") if s]
    results = []
    for k in range(args.sets):
        for seed in seeds:
            cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", args.workload,
                   "--seed", seed, "--seconds", str(seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            line = {"set": k, "seed": int(seed), "rc": proc.returncode, "wall_s": wall}
            if proc.returncode == 0 and lines:
                line.update(json.loads(lines[-1]))
            else:
                line["stderr"] = proc.stderr[-3000:]
            results.append(line)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"workload": args.workload, **line}) + "\n")
    names = sorted({m for r in results for m in r.get("metrics", {})})
    for name in names:
        for k in range(args.sets):
            vals = [r["metrics"][name]["value"] for r in results
                    if r["set"] == k and name in r.get("metrics", {})]
            if len(vals) >= 2:
                print(f"{args.workload} {name} set {k}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals)!r} n {len(vals)}")
    ok = all(r.get("correct") for r in results)
    print(f"{args.workload}: {len(results)} runs, all correct: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
