#!/usr/bin/env python3
"""Time the port's federated rounds at a configuration, without a check.

    python3 benchmark/tools/fed_probe.py --config faz_lc_multihead_fp32 --seed <n> \
        --rounds 8 --train 61,38,50,177,12 --test 15,13,25,76,3 [--ala-skip 10] \
        [--out chiprun_out/fed_probe.jsonl]

A probe for a later federated cell, not a cell: it measures what such a
cell's window would hold. ``federation.build_experiment`` over splits made
from the seed (the local-rounds traffic's images and weak labels for
training, its ground truth for validation, moved to the host), then
``FederatedServer.run`` for ``--rounds`` rounds, evaluation every
``eval_iters`` iterations, own-best checkpoints under ``$TMPDIR``. One JSON
line a round: its ``round_duration`` (host clock, from the server), whether
it evaluated, and each client's ALA report.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, default=8)
    parser.add_argument("--train", required=True, help="train images a client, comma-separated")
    parser.add_argument("--test", required=True, help="validation images a client")
    parser.add_argument("--ala-skip", type=int, default=10)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (a small size to debug)")
    parser.add_argument("--img-size", type=int, default=None, help="cut the images (debugging)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("fed_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import inputs
    from fedicra_torch.data.h5io import ClientSplit
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.federation import build_experiment

    config = json.loads((ROOT / "benchmark" / "configs" / f"{args.config}.json").read_text())
    precision = json.loads((ROOT / "benchmark" / "precisions" / f"{config['precision']}.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "local_rounds.json").read_text())
    env.set_precision(precision)
    task, t = dict(config["task"]), config["train"]
    if args.img_size:
        task["img_size"] = args.img_size
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    h = w = task["img_size"]
    splits = {}
    for cid, (n_train, n_test) in enumerate(zip(map(int, args.train.split(",")),
                                                map(int, args.test.split(",")))):
        images, labels = inputs.client_pool(args.seed, cid, n_train, task, traffic, dev)
        g = inputs.generator(dev, args.seed, "val", cid)
        val_images = inputs.smooth_images(g, n_test, h, w, task["in_chns"], traffic["images"], dev)
        val_gt = inputs.ground_truth(g, n_test, h, w, task["num_classes"], traffic["labels"], dev)
        splits[cid] = {
            "train": ClientSplit(images.cpu().numpy(), labels.to(torch.uint8).cpu().numpy(),
                                 [f"c{cid}_train{i}" for i in range(n_train)]),
            "val": ClientSplit(val_images.cpu().numpy(), val_gt.to(torch.uint8).cpu().numpy(),
                               [f"c{cid}_val{i}" for i in range(n_test)]),
        }
    cfg = TrainConfig.for_task(task["img_class"], model=config["model"], img_size=task["img_size"],
                               amp=precision["autocast"] == "bfloat16", ala_skip_iters=args.ala_skip,
                               seed=args.seed % 2**31, **{k: t[k] for k in (
                                   "procedure", "strategy", "batch_size", "tree_loss_weight",
                                   "gatecrf_weight", "gatecrf_radius", "alpha", "iters",
                                   "rep_iters", "base_lr", "max_iterations")})
    snapshots = Path(tempfile.gettempdir()) / "fed_probe_snapshots"
    server = build_experiment(cfg, splits=splits, snapshot_dir=str(snapshots), device=dev)
    t_built = time.perf_counter()
    out = open(args.out, "a") if args.out else None
    for r in range(args.rounds):
        server.run(num_rounds=(r + 1) * cfg.iters, progress=False)
        rec = server.history[-1]
        line = {"config": args.config, "seed": args.seed, "round": rec["round"],
                "round_duration": rec.get("round_duration"),
                "evaluated": "val_mean_dice" in rec, "val_mean_dice": rec.get("val_mean_dice"),
                "ala": [{k: v for k, v in c.ala_report.items() if isinstance(v, (int, float))}
                        for c in server.clients]}
        if r == 0:
            line["setup_s"] = t_built - t_start
            line["device"] = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        if dev.type == "cuda":
            line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    loaded = env.forbidden_modules()
    if loaded:
        print(f"fed_probe: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
