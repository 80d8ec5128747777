"""Experiment assembly: build model, clients, and server for a federation.

Counterpart of ``fedicra_tpu/federation/experiment.py``, the in-process
counterpart of the reference launcher + per-process mains (flower_runner.py
+ …_Ours.py main()): one Python process hosts the server and every client on
one device, and the clients train in turn on one shared model object; the
payloads are dicts of tensors on that device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..data.h5io import ClientSplit, load_client_split, make_synthetic_split
from ..device import resolve_device
from ..engine.config import PERSONALIZED_FL, TASKS, TrainConfig
from ..engine.trainer import init_client_state, make_round_fn
from ..evaluation.evaluate import evaluate_client
from ..models import net_factory
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricsWriter
from .client import FederatedClient, val_metrics
from .server import FederatedServer
from .strategies import get_strategy


def load_task_splits(
    cfg: TrainConfig,
    data_root: Optional[str],
    limit_per_client: Optional[int] = None,
    synthetic: bool = False,
) -> Dict[int, Dict[str, ClientSplit]]:
    """Per-client train/val splits.

    ``synthetic=True`` is the ONLY way to get generated data; a missing or
    wrong ``data_root`` raises instead of silently substituting synthetic
    splits (a real run that silently switches datasets gives plausible
    looking but meaningless metrics)."""
    task = TASKS[cfg.img_class]
    sup_types = task["sup_types"]
    out = {}
    root = os.path.join(data_root, task["root_subdir"]) if data_root else None
    if not synthetic and not (root and os.path.isdir(root)):
        raise FileNotFoundError(
            f"data root for task {cfg.img_class!r} not found "
            f"({root!r}); pass a valid --root_path, or request synthetic "
            f"data EXPLICITLY (--synthetic / synthetic=True)"
        )
    for cid, (client, sup) in enumerate(sup_types.items()):
        if not synthetic:
            print(f"[data] loading {client} ({sup}) from {root}", flush=True)
            train = load_client_split(root, client, "train", sup, limit_per_client)
            val = load_client_split(root, client, "val", "mask", limit_per_client)
            print(f"[data] {client}: train={len(train)} val={len(val)}", flush=True)
        else:
            n = limit_per_client or 24
            train = make_synthetic_split(
                n, cfg.img_size, cfg.img_size, cfg.in_chns, cfg.num_classes,
                seed=cid, sparse=True, sup_type=sup,
            )
            val = make_synthetic_split(
                max(n // 3, 2), cfg.img_size, cfg.img_size, cfg.in_chns,
                cfg.num_classes, seed=100 + cid, sparse=False,
            )
        out[cid] = {"train": train, "val": val}
    return out


def build_experiment(
    cfg: TrainConfig,
    data_root: Optional[str] = None,
    snapshot_dir: Optional[str] = None,
    limit_per_client: Optional[int] = None,
    splits: Optional[Dict[int, Dict[str, ClientSplit]]] = None,
    synthetic: bool = False,
    device=None,
) -> FederatedServer:
    """The server with its clients, on the card unless ``device`` names one."""
    cfg = cfg.validate()
    device = resolve_device(device)
    model = net_factory(
        cfg.model,
        in_chns=cfg.in_chns,
        class_num=cfg.num_classes,
        num_clients=cfg.num_clients,
        client_id=0,
    )
    init_state = init_client_state(model, cfg, device=device)
    round_fn = make_round_fn(model, cfg, device=device)

    if splits is None:
        splits = load_task_splits(cfg, data_root, limit_per_client, synthetic=synthetic)

    # one manager shared by the server (aggregate best, periodic, resume)
    # and the clients (client-side own-best, flower_common.py:106-114)
    ckpt = CheckpointManager(snapshot_dir) if snapshot_dir else None

    clients: List[FederatedClient] = [
        FederatedClient(
            cid=cid,
            cfg=cfg,
            model=model,
            train_split=splits[cid]["train"],
            val_split=splits[cid]["val"],
            round_fn=round_fn,
            init_state=init_state,
            ckpt=ckpt,
            device=device,
        )
        for cid in range(cfg.num_clients)
    ]
    initial_payload = {"params": init_state.params, "batch_stats": init_state.batch_stats}
    return FederatedServer(
        cfg=cfg,
        clients=clients,
        strategy=get_strategy(cfg.strategy),
        initial_payload=initial_payload,
        snapshot_dir=snapshot_dir,
        writer=MetricsWriter(snapshot_dir),
        central_eval_fn=make_central_eval_fn(model, cfg, splits, device=device),
        ckpt=ckpt,
    )


def make_central_eval_fn(model, cfg: TrainConfig, splits, device=None):
    """Server-side central evaluation of the aggregated model: the
    reference's get_evaluate_fn over the 'client_all' val loader
    (flower_common.py:139-151), run every eval round by MyServer.fit for
    centralised strategies only (:288-301). None for personalised ones."""
    if cfg.strategy in PERSONALIZED_FL:
        return None

    # client_all == the union of every domain's val split (dataset.py:98-171)
    images = np.concatenate([splits[c]["val"].images for c in sorted(splits)])
    labels = np.concatenate([splits[c]["val"].labels for c in sorted(splits)])

    def central_eval(payload):
        return val_metrics(evaluate_client(
            model, payload["params"], payload["batch_stats"], images, labels,
            cfg.num_classes, emb_idx=0, device=device,
        ))

    return central_eval
