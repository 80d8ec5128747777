#!/usr/bin/env python3
"""The readings a federated-rounds cell's limits are set from, on one card.

    python3 benchmark/tools/fed_readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2] [--fault-seeds 1] [--out fed_readings.jsonl]

Each seed runs the port's ``ShardedFederation`` in this process on a
(1, 1) mesh that holds every client, set up as a run sets it up, then the
checked round, then the reference from the program's inputs to each stage
of every client (``drivers/fed_rounds.py``): each client's stages are those
of its rank in a run; the aggregate is a mean on one card where a run's is
an all-reduce. One JSON line a reading, the worst over the clients beside
each client's:

- ``program``: the port against the reference;
- ``control`` (control seeds): the reference with its convolutions'
  operands rounded to the precision file's ``control_mantissa_bits`` (10,
  TF32, for float32), from the same stage inputs, in the program's place;
  ``half_batch``: the reference trained on half of each batch;
- faults of the program (fault seeds): ``ala_gates_one`` (ALA's gates held
  at one, so the merge returns the local weights), ``own_state`` (the
  aggregate replaced by the rank's first client's returned state),
  ``tf32`` (the program with both TF32 switches on, a rank left at
  PyTorch's defaults).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("ala_gates_one", "own_state", "tf32")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    import torch

    from benchmark.drivers import fed_rounds
    from benchmark.run import load_cell

    if not torch.cuda.is_available():
        print("fed_readings: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if cell["traffic"]["kind"] != "fed_rounds":
        print(f"fed_readings: reads federated-rounds cells; {args.workload} is {cell['traffic']['kind']}",
              file=sys.stderr)
        return 2
    config, precision, traffic = cell["config"], cell["precision"], cell["traffic"]
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, clients, fed=None):
        worst = {k: max(c[k] for c in clients.values()) for k in next(iter(clients.values()))}
        text = json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **worst, **(fed or {}),
                           "clients": {str(c): v for c, v in clients.items()}})
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def checked(seed, fault=None):
        """The program's checked round under ``fault``."""
        from fedicra_torch.federation import ala, sharded

        saved = (ala.ala_epoch, sharded._fedavg)
        if fault == "ala_gates_one":
            ala.ala_epoch = lambda model, cfg, gates, *rest: (gates, 0.0)
        elif fault == "own_state":
            sharded._fedavg = lambda trees, weights, total, group: dict(trees[0])
        env.set_precision({**precision, "allow_tf32": True} if fault == "tf32" else precision)
        try:
            prog = fed_rounds.Program(config, precision, traffic, seed, dev)
            res = prog.checked_round()
            off = fed_rounds.off_precision(fed_rounds.switches(), precision)
        finally:
            ala.ala_epoch, sharded._fedavg = saved
            env.set_precision(precision)
        del prog
        free()
        refs = {c: fed_rounds.reference_readings(config, traffic, seed, dev, stages=v["stages"])
                for c, v in res["clients"].items()}
        clients = {c: fed_rounds.client_checks(v["program"], refs[c]) for c, v in res["clients"].items()}
        fed = fed_rounds.federation_checks(clients, res["global"], res["held"], int(off), traffic)
        return res, refs, clients, fed

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    for seed in sorted(set(seeds) | set(controls)):
        res, refs, clients, fed = checked(seed)
        if seed in seeds:
            emit("program", seed, clients, fed)
        if seed in controls:
            for kind, kw in (("control", {"round_bits": precision["control_mantissa_bits"]}),
                             ("half_batch", {"fault": "half_batch"})):
                other = {c: fed_rounds.client_checks(
                    fed_rounds.reference_readings(config, traffic, seed, dev, stages=v["stages"], **kw), refs[c])
                    for c, v in res["clients"].items()}
                free()
                emit(kind, seed, other)
        del res, refs
        free()
    for seed in faults:
        for fault in FAULTS:
            _, _, clients, fed = checked(seed, fault=fault)
            emit(fault, seed, clients, fed)
            free()
    text = json.dumps({"kind": "device", "name": torch.cuda.get_device_name(0),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(text, flush=True)
    if out:
        out.write(text + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
