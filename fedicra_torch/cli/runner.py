"""Launcher CLI mirroring the reference flower_runner.py flag surface.

Counterpart of ``fedicra_tpu/cli/runner.py``. The reference composes
per-role shell commands and spawns 1 server + N client processes, one GPU
each (flower_runner.py:96-122). Here the same experiment-level flags
configure the in-process run of ``fedicra_torch.cli.train`` on one card.

The per-task supervision tables (odoc/faz/polyp) and the procedure/strategy
asserts match flower_runner.py:57-94. ``--gpus`` is accepted for flag
parity and unused. ``--distributed`` (1 server + N client processes over
TCP) waits for the port's transport (ROADMAP.md, queue 1) and is refused.
"""

from __future__ import annotations

import argparse

PROCEDURE_ALIASES = {
    # reference script names -> our procedure ids
    "flower_pCE_2D": "pce",
    "flower_pCE_MScaleTreeEnergyLoss_ADD": "treeenergy_add",
    "flower_pCE_2D_GateCRFMsacleTreeEnergyLoss_Ours": "ours",
    "pce": "pce",
    "treeenergy_add": "treeenergy_add",
    "ours": "ours",
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=9009,
                   help="transport port (distributed mode, not ported)")
    p.add_argument("--debug", type=int, default=0,
                   help="print the composed configuration without running")
    p.add_argument("--procedure", type=str, required=True)
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--gpus", nargs="+", type=int, default=None,
                   help="accepted for flag parity; the run uses one card")
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--img_class", type=str, default="faz")
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--eval_iters", type=int, default=20)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--tree_loss_weight", type=float, default=0.1)
    p.add_argument("--strategy", type=str, default="FedAvg")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--amp", type=int, default=0)
    p.add_argument("--encoder_weights", type=str, default=None,
                   help="efficientnet-pytorch B3 .pth for efficient_unet (passed on "
                        "to the train CLI when given)")
    p.add_argument("--rep_iters", type=int, default=3)
    p.add_argument("--root_path", type=str, default="../data")
    p.add_argument("--synthetic", action="store_true",
                   help="explicit opt-in to generated data (otherwise a "
                        "missing --root_path is an error)")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet: 1 server + N client processes over TCP")
    args = p.parse_args(argv)

    assert args.img_class in ["odoc", "faz", "polyp"]
    assert args.procedure in PROCEDURE_ALIASES, (
        f"unknown procedure {args.procedure}"
    )
    procedure = PROCEDURE_ALIASES[args.procedure]

    from ..engine.config import TASKS

    task = TASKS[args.img_class]
    train_args = [
        "--root_path", args.root_path,
        "--img_class", args.img_class,
        "--exp", args.exp,
        "--model", args.model,
        "--procedure", procedure,
        "--strategy", args.strategy,
        "--max_iterations", str(args.max_iterations),
        "--iters", str(args.iters),
        "--eval_iters", str(args.eval_iters),
        "--batch_size", str(args.batch_size),
        "--base_lr", str(args.base_lr),
        "--alpha", str(args.alpha),
        "--rep_iters", str(args.rep_iters),
        "--tree_loss_weight", str(args.tree_loss_weight),
        "--img_size", str(args.img_size),
        "--amp", str(args.amp),
    ]
    if args.encoder_weights:
        train_args += ["--encoder_weights", args.encoder_weights]
    if args.synthetic:
        train_args.append("--synthetic")

    if args.debug:
        print("config:", " ".join(train_args))
        print("clients:", task["sup_types"])
        return None

    if args.distributed:
        raise NotImplementedError(
            "--distributed needs the port's TCP transport, which is not ported "
            "yet (ROADMAP.md, queue 1: federation/transport.py); run without it "
            "to federate the clients in one process on one card"
        )
    from .train import main as train_main

    return train_main(train_args)


if __name__ == "__main__":
    main()
