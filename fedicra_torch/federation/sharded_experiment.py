"""The SPMD federation's training loop over the sharded round.

Counterpart of ``fedicra_tpu/federation/sharded_experiment.py``. Where the
in-process federation (``experiment.py``) drives each client in turn through
the server, as the reference does, this loop runs every round as
``sharded.py``'s round over a (client, data) mesh of process ranks: each
rank holds a block of the clients, their batches may be split further over
a data axis, and the aggregate is an all-reduce over the client axis.

Every rank runs the same loop. Per client, as JAX's loop: a train batcher
and an ALA batcher (seeds ``seed * 1000 + cid`` and ``+ 500``), an ALA epoch
counter carried across rounds, and the weight of its batch count. With
splits of one size the round draws ALA's epochs from the split arrays;
with ragged ones it replays each round's ALA epoch, tiled to the largest
client's batch count. Evaluation runs where a client's state lives, on the
rank of data index 0; the metrics are gathered to every rank, rank 0 writes
them and prints the progress.

Beyond JAX's loop: the rounds' non-scalar metrics (``vis_pred`` under
"ours") are left out of the records, since JAX's ``run_round`` cannot
convert them and stops; ``run_sharded`` starts the ranks.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..data.batcher import EpochBatcher
from ..device import resolve_device
from ..engine.config import TrainConfig
from ..engine.trainer import ClientState, init_client_state
from ..evaluation.evaluate import evaluate_client
from ..models import net_factory
from ..parallel.launch import spawn_ranks
from ..parallel.mesh import make_mesh
from ..utils.logging import MetricsWriter
from .client import copy_generator
from .experiment import load_task_splits
from .sharded import check_strategy, make_sharded_round_fn


def _gather(obj) -> list:
    """``obj`` of every rank, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class ShardedFederation:
    def __init__(
        self,
        cfg: TrainConfig,
        data_root: Optional[str] = None,
        snapshot_dir: Optional[str] = None,
        limit_per_client: Optional[int] = None,
        mesh=None,
        splits=None,
        synthetic: bool = False,
        device=None,
    ):
        self.cfg = cfg.validate()
        check_strategy(cfg)
        self.device = resolve_device(device)
        self.mesh = mesh or make_mesh(num_clients=cfg.num_clients)
        if cfg.num_clients % self.mesh.shape[0]:
            raise ValueError("num_clients must be divisible by the client mesh axis")
        self.model = net_factory(
            cfg.model,
            in_chns=cfg.in_chns,
            class_num=cfg.num_classes,
            num_clients=cfg.num_clients,
            client_id=0,
        )
        base = init_client_state(self.model, cfg, device=self.device)
        K, bs = cfg.num_clients, cfg.batch_size
        held = self.mesh.clients
        # every client starts from the same weights and dropout stream, as
        # the in-process clients do
        self.states = {
            cid: ClientState(base.params, base.batch_stats, 0, copy_generator(base.generator))
            for cid in held
        }
        self.global_payload = {"params": base.params, "batch_stats": base.batch_stats}
        if splits is None:
            splits = load_task_splits(cfg, data_root, limit_per_client, synthetic=synthetic)
        self.splits = splits
        self.batchers = {
            cid: EpochBatcher(splits[cid]["train"], bs, cfg.num_classes, cfg.img_class,
                              seed=cfg.seed * 1000 + cid, device=self.device)
            for cid in held
        }
        self.ala_batchers = {
            cid: EpochBatcher(splits[cid]["train"], bs, cfg.num_classes, cfg.img_class,
                              seed=cfg.seed * 1000 + 500 + cid, source=self.batchers[cid])
            for cid in held
        }
        sizes = [len(splits[c]["train"]) for c in range(K)]
        # ragged splits: each round's ALA epoch tiled to a common batch count
        self.ala_nb = max(math.ceil(n / bs) for n in sizes)
        if cfg.fedicra and len(set(sizes)) == 1:
            self.ala_raw = {cid: {"image": b._images_dev, "label": b._labels_dev}
                            for cid, b in self.ala_batchers.items()}
            self.ala_seeds = {cid: b.seed for cid, b in self.ala_batchers.items()}
        else:
            self.ala_raw = self.ala_seeds = None
        self.ala_counters = {cid: 0 for cid in held}
        # ALA's dropout streams, seeded as the in-process client's
        self.ala_generators = {
            cid: torch.Generator(device=self.device).manual_seed(cfg.seed * 7919 + cid)
            for cid in held
        }
        self.weights = [math.ceil(n / bs) for n in sizes]
        self.round_fn = make_sharded_round_fn(self.model, cfg, self.mesh, device=self.device)
        self.writer = MetricsWriter(snapshot_dir if self.mesh.rank == 0 else None)
        self.current_round = 0
        self.best_dice = 0.0
        self.history: List[Dict] = []

    def _ala_epoch_tensor(self, cid: int, epoch: int) -> Dict[str, torch.Tensor]:
        bi, bl = self.ala_batchers[cid].epoch_arrays(epoch)
        reps = -(-self.ala_nb // bi.shape[0])
        return {"image": bi.repeat(reps, 1, 1, 1, 1)[: self.ala_nb],
                "label": bl.repeat(reps, 1, 1, 1)[: self.ala_nb]}

    def run_round(self, on_step=None) -> Dict[str, float]:
        """One round; returns every client's last-step scalar metrics as
        ``client_{cid}_{name}``. ``on_step(cid, j, metrics_j)`` is passed to
        the round."""
        cfg = self.cfg
        current_round = self.current_round + cfg.iters
        held = self.mesh.clients
        batches = {cid: self.batchers[cid].batches_for_round(self.states[cid].current_iter,
                                                             cfg.iters)
                   for cid in held}
        ala = (
            {cid: self._ala_epoch_tensor(cid, current_round // max(cfg.iters, 1)) for cid in held}
            if cfg.fedicra and self.ala_raw is None
            else None
        )
        self.states, self.global_payload, metrics, self.ala_counters = self.round_fn(
            self.states, self.global_payload, batches, ala, current_round, self.weights,
            ala_raw=self.ala_raw, ala_seeds=self.ala_seeds, ala_counters=self.ala_counters,
            ala_generators=self.ala_generators, on_step=on_step,
        )
        del batches, ala
        for b in (*self.batchers.values(), *self.ala_batchers.values()):
            b.drop_epoch_cache()  # rebuilt from its seed when next needed
        self.current_round = current_round
        local = {}
        if self.mesh.coords[1] == 0:
            local = {cid: {k: float(v[-1]) for k, v in m.items() if v.ndim == 1}
                     for cid, m in metrics.items()}
        per_client = {c: m for part in _gather(local) for c, m in part.items()}
        names = list(per_client[0])
        return {f"client_{c}_{k}": per_client[c][k]
                for k in names for c in range(cfg.num_clients)}

    def evaluate(self) -> Dict[str, float]:
        cfg = self.cfg
        local = {}
        if self.mesh.coords[1] == 0:
            for cid in self.mesh.clients:
                val = self.splits[cid]["val"]
                m = evaluate_client(
                    self.model, self.states[cid].params, self.states[cid].batch_stats,
                    val.images, val.labels, cfg.num_classes, emb_idx=cid, device=self.device,
                )
                local[cid] = (m, len(val))
        results = {c: r for part in _gather(local) for c, r in part.items()}
        per_client = {f"client_{cid}_{k}": v
                      for cid in range(cfg.num_clients) for k, v in results[cid][0].items()}
        weights = {cid: results[cid][1] for cid in range(cfg.num_clients)}
        total = sum(weights.values())
        for k in ("mean_dice", "mean_hd95"):
            per_client[f"val_{k}"] = sum(
                weights[c] * per_client[f"client_{c}_{k}"] for c in weights
            ) / total
        return per_client

    def run(self, num_rounds: Optional[int] = None, progress: bool = True):
        cfg = self.cfg
        max_iters = num_rounds or cfg.max_iterations
        while self.current_round < max_iters:
            t0 = time.perf_counter()
            m = self.run_round()
            rec = {"round": self.current_round, **m}
            if self.current_round % cfg.eval_iters == 0:
                ev = self.evaluate()
                rec.update(ev)
                self.best_dice = max(self.best_dice, ev.get("val_mean_dice", 0))
            rec["round_duration"] = time.perf_counter() - t0
            self.writer.write(self.current_round, rec)
            self.history.append(rec)
            if progress and self.mesh.rank == 0:
                print(f"[sharded round {self.current_round}] "
                      f"dur={rec['round_duration']:.2f}s", flush=True)
        return self.history


def _run(device, cfg, data_root, snapshot_dir, limit_per_client, synthetic, num_rounds) -> dict:
    fed = ShardedFederation(cfg, data_root=data_root, snapshot_dir=snapshot_dir,
                            limit_per_client=limit_per_client, synthetic=synthetic, device=device)
    history = fed.run(num_rounds)
    fed.writer.close()
    payload = {part: {k: v.cpu() for k, v in tree.items()}
               for part, tree in fed.global_payload.items()}
    return {"history": history, "best_dice": fed.best_dice, "global_payload": payload,
            "mesh": fed.mesh.shape}


def _rank_run(rank: int, device: str, out: str, *args) -> None:
    result = _run(device, *args)
    if rank == 0:
        torch.save(result, out)


def sharded_layout(device=None) -> Tuple[List[str], Optional[str]]:
    """The ranks of ``--sharded`` as (devices, backend): one on ``device``
    when it is named, else one per visible card over NCCL (one card: this
    process). Raises without a card, unless a device is named."""
    if device is not None:
        return [str(torch.device(device))], None
    resolve_device()  # no card: refuse here, before any model or process
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)], ("nccl" if n > 1 else None)


def run_sharded(
    cfg: TrainConfig,
    devices: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
    data_root: Optional[str] = None,
    snapshot_dir: Optional[str] = None,
    limit_per_client: Optional[int] = None,
    synthetic: bool = False,
    num_rounds: Optional[int] = None,
) -> dict:
    """The sharded federation over one rank per entry of ``devices`` (one
    entry: in this process, with no process group; more: spawned ranks over
    ``backend``). ``devices=None`` takes ``sharded_layout()``: every visible
    card, or RuntimeError without one. Returns rank 0's {"history",
    "best_dice", "global_payload" (on the CPU), "mesh"}; raises RuntimeError
    naming any rank that failed."""
    check_strategy(cfg)
    if devices is None:
        devices, layout_backend = sharded_layout()
        backend = backend or layout_backend
    args = (cfg, data_root, snapshot_dir, limit_per_client, synthetic, num_rounds)
    if len(devices) == 1:
        return _run(devices[0], *args)
    with tempfile.TemporaryDirectory(prefix="fedicra_sharded_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        spawn_ranks(_rank_run, (out, *args), backend, devices)
        return torch.load(out)
