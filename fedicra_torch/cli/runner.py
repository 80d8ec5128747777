"""Launcher CLI mirroring the reference flower_runner.py flag surface.

Counterpart of ``fedicra_tpu/cli/runner.py``. The reference composes
per-role shell commands and spawns 1 server + N client processes, one GPU
each (flower_runner.py:96-122). Here the same experiment-level flags
configure either:

- the default in-process run of ``fedicra_torch.cli.train`` on one card
  (no processes, no sockets), or
- ``--distributed``: 1 server + N client OS processes federated over the
  TCP transport (``federation/transport.py``), the reference's execution
  model, all on one card; the clients reach the server through the
  transport's connection retries.

The per-task supervision tables (odoc/faz/polyp) and the procedure/strategy
asserts match flower_runner.py:57-94. ``--gpus`` is accepted for flag
parity and unused.

Beside JAX's runner, the distributed route trains the configuration the
in-process route trains (``--img_size`` and ``--encoder_weights`` reach
every process), and it fails when a process fails: once any process exits
non-zero, the runner stops the others and raises, naming each process by
role, cid and exit code.

Usage:
  python -m fedicra_torch.cli.runner --procedure ours --strategy FedICRA \
      --model unet_lc_multihead --img_class odoc --exp myrun --distributed
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..device import resolve_device

PROCEDURE_ALIASES = {
    # reference script names -> our procedure ids
    "flower_pCE_2D": "pce",
    "flower_pCE_MScaleTreeEnergyLoss_ADD": "treeenergy_add",
    "flower_pCE_2D_GateCRFMsacleTreeEnergyLoss_Ours": "ours",
    "pce": "pce",
    "treeenergy_add": "treeenergy_add",
    "ours": "ours",
}


def main(argv=None, *, device=None):
    """Run the launcher. ``device`` names the device of every process (by
    default the CUDA card; tests pass ``"cpu"``). Returns the train CLI's
    result on the in-process route, None otherwise."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=9009,
                   help="transport port (distributed mode)")
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
                   help="run 1 server + N client OS processes over TCP")
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
        return _run_distributed(args, procedure, task, device)
    from .train import main as train_main

    if device is not None:
        train_args += ["--device", str(device)]
    return train_main(train_args)


def _run_distributed(args, procedure, task, device=None):
    """Reference execution model: per-role OS processes over the transport.

    Raises RuntimeError when any process exits non-zero; the processes
    still running then are stopped (a dead client fails every later round,
    and a server waiting for a client that never registers would wait out
    its accept timeout)."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    device = str(resolve_device(device))  # fail here, before any process starts
    num_clients = len(task["sup_types"])
    ctx = mp.get_context("spawn")
    procs = {"server": ctx.Process(target=_server_proc, args=(args, procedure, num_clients, device))}
    for cid in range(num_clients):
        procs[f"client {cid}"] = ctx.Process(target=_client_proc, args=(args, procedure, cid, device))
    stopped = []
    try:
        for pr in procs.values():
            pr.start()
        while True:
            alive = [pr for pr in procs.values() if pr.is_alive()]
            if not alive or any(pr.exitcode not in (None, 0) for pr in procs.values()):
                break
            wait([pr.sentinel for pr in alive])  # until one of them exits
    finally:
        for name, pr in procs.items():
            if pr.is_alive():
                pr.terminate()
                stopped.append(name)
        for pr in procs.values():
            if pr.pid is not None:  # started
                pr.join()
    failed = [f"{name} exited with code {pr.exitcode}" for name, pr in procs.items()
              if pr.exitcode != 0 and name not in stopped]
    if failed:
        raise RuntimeError("distributed run failed: " + "; ".join(failed)
                           + ("; stopped " + ", ".join(stopped) if stopped else ""))
    return None


def _build_cfg(args, procedure):
    """The run's TrainConfig, from the same flags the in-process route
    passes to the train CLI (``--img_size`` and ``--encoder_weights``
    included)."""
    from ..engine.config import TrainConfig

    overrides = dict(
        model=args.model,
        procedure=procedure,
        strategy=args.strategy,
        max_iterations=args.max_iterations,
        iters=args.iters,
        eval_iters=args.eval_iters,
        batch_size=args.batch_size,
        base_lr=args.base_lr,
        alpha=args.alpha,
        rep_iters=args.rep_iters,
        tree_loss_weight=args.tree_loss_weight,
        amp=bool(args.amp),
        img_size=args.img_size,
    )
    if args.encoder_weights:
        overrides["encoder_weights"] = args.encoder_weights
    return TrainConfig.for_task(args.img_class, **overrides).validate()


def _report(line: str) -> None:
    """One line in one write, so the processes' lines never interleave."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _peak_memory(device) -> str:
    if torch.device(device).type != "cuda":
        return "not measured (no card)"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def _server_proc(args, procedure, num_clients, device):
    from ..engine.trainer import init_client_state
    from ..federation.server import FederatedServer
    from ..federation.strategies import get_strategy
    from ..federation.transport import accept_clients
    from ..models import net_factory
    from ..utils.logging import MetricsWriter

    cfg = _build_cfg(args, procedure)
    model = net_factory(cfg.model, in_chns=cfg.in_chns, class_num=cfg.num_classes,
                        num_clients=cfg.num_clients)
    init_state = init_client_state(model, cfg, device=device)
    proxies = accept_clients("0.0.0.0", args.port, num_clients, device=device)
    snapshot = os.path.join("../model", args.exp)
    server = FederatedServer(
        cfg=cfg,
        clients=proxies,
        strategy=get_strategy(cfg.strategy),
        initial_payload={"params": init_state.params, "batch_stats": init_state.batch_stats},
        snapshot_dir=snapshot,
        writer=MetricsWriter(snapshot),
    )
    t0 = time.perf_counter()
    try:
        server.run()
    finally:
        for prx in proxies:
            prx.close()
        server.writer.close()
    rounds = [round(h["round_duration"], 3) for h in server.history if "round_duration" in h]
    _report(f"[server] run {time.perf_counter() - t0:.3f} s; rounds {rounds} s; "
            f"peak memory {_peak_memory(device)}")


def _client_proc(args, procedure, cid, device):
    from ..engine.trainer import init_client_state, make_round_fn
    from ..federation.client import FederatedClient
    from ..federation.experiment import load_task_splits
    from ..federation.transport import serve_client
    from ..models import net_factory
    from ..utils.checkpoint import CheckpointManager

    cfg = _build_cfg(args, procedure)
    model = net_factory(cfg.model, in_chns=cfg.in_chns, class_num=cfg.num_classes,
                        num_clients=cfg.num_clients)
    splits = load_task_splits(cfg, args.root_path, synthetic=args.synthetic)
    # the weights are drawn before make_round_fn moves the model to the device
    init_state = init_client_state(model, cfg, device=device)
    # client-side own-best checkpoints land in the shared snapshot dir, like
    # the reference's per-process clients writing to one snapshot_path
    client = FederatedClient(
        cid=cid,
        cfg=cfg,
        model=model,
        train_split=splits[cid]["train"],
        val_split=splits[cid]["val"],
        round_fn=make_round_fn(model, cfg, device=device),
        init_state=init_state,
        ckpt=CheckpointManager(os.path.join("../model", args.exp)),
        device=device,
    )
    serve_client(client, "127.0.0.1", args.port)
    _report(f"[client {cid}] peak memory {_peak_memory(device)}")

if __name__ == "__main__":
    main()
