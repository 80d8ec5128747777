#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out chiprun_out/readings.jsonl]

For each seed: the program's checked round (set-up as a run makes it)
against the reference (the ``program`` line). For each control seed, the
reference itself in place of the program, twice: with its convolutions'
operands rounded to the precision file's ``control_mantissa_bits``
(``control``; 10, TF32, for float32), and trained on half of each batch
(``half_batch``, a fault). One JSON line each, with every compared number;
the limits come from the largest program reading and the smallest control
and fault readings. No measured window: a training cell's readings need
none. A state returned unchanged reads 1 on ``change`` by construction.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    from benchmark.run import load_cell

    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.drivers import local_rounds

    cell = load_cell(args.workload)
    config, precision, traffic = cell["config"], cell["precision"], cell["traffic"]
    if traffic["kind"] != "local_rounds":
        print(f"readings: reads local-rounds cells; {args.workload} is {traffic['kind']}", file=sys.stderr)
        return 2
    env.set_precision(precision)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps({"workload": args.workload, **line})
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        ref = local_rounds.reference_readings(config, traffic, seed, dev)
        t_ref = time.perf_counter() - t0
        free()
        if seed in seeds:
            t0 = time.perf_counter()
            prog = local_rounds.Program(config, precision, traffic, seed, dev)
            checked = prog.checked_round()
            del prog
            free()
            emit({"kind": "program", "seed": seed, "seconds": time.perf_counter() - t0,
                  "reference_seconds": t_ref, **local_rounds.compare(checked, ref),
                  "depths": ref["depths"].tolist() if ref["depths"] is not None else None})
        if seed in controls:
            for kind, kw in (("control", {"round_bits": precision["control_mantissa_bits"]}),
                             ("half_batch", {"fault": "half_batch"})):
                other = local_rounds.reference_readings(config, traffic, seed, dev, **kw)
                free()
                emit({"kind": kind, "seed": seed, **local_rounds.compare(other, ref)})
    emit({"kind": "device", "name": torch.cuda.get_device_name(0),
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
