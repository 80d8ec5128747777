"""Federated server: round loop, metric aggregation, checkpointing, resume.

Counterpart of ``fedicra_tpu/federation/server.py``; mirrors MyServer.fit
(flower_common.py:191-390):
- round index == global iteration count: rounds advance by ``iters``
  (range(iters, num_rounds+iters, iters), :258);
- each round: fit all clients in turn -> strategy aggregation -> metric
  logging;
- every ``eval_iters`` iterations: client evaluation with per-client,
  weighted (by val size) and unweighted aggregate metrics
  (get_evaluate_metrics_aggregation_fn, :398-428);
- best-dice and periodic (every ``ckpt_iters``) checkpoints (:341-381).

Checkpoint split (reference semantics): the SERVER saves the aggregate best
(the global payload at the round where the weighted mean val dice peaked);
each CLIENT saves its own state at its own best val_mean_dice
(flower_common.py:106-114).

Beyond the reference: full resume (server + in-process client states), and
``run(stop_fn=...)``, which ends the run at a round boundary with a fresh
resume snapshot.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..engine.config import TrainConfig
from ..engine.trainer import ClientState
from ..evaluation.metrics import METRIC_NAMES
from ..utils.checkpoint import CheckpointManager, client_state_tree
from ..utils.logging import MetricsWriter
from .api import EvaluateIns, FitIns
from .client import FederatedClient
from .strategies import Strategy


class FederatedServer:
    def __init__(
        self,
        cfg: TrainConfig,
        clients: List[FederatedClient],
        strategy: Strategy,
        initial_payload,
        snapshot_dir: Optional[str] = None,
        writer: Optional[MetricsWriter] = None,
        central_eval_fn=None,
        ckpt: Optional[CheckpointManager] = None,
    ):
        self.cfg = cfg
        self.clients = clients
        self.strategy = strategy
        self.global_payload = initial_payload
        # server-side evaluation of the AGGREGATED model on the client_all
        # val split, every eval round, for non-personalised strategies (the
        # reference's get_evaluate_fn, flower_common.py:139-151, called from
        # MyServer.fit :288-301). Signature: payload -> Dict[str, float].
        self.central_eval_fn = central_eval_fn
        self.writer = writer or MetricsWriter(snapshot_dir)
        if ckpt is None and snapshot_dir:
            ckpt = CheckpointManager(snapshot_dir)
        self.ckpt = ckpt
        self.best_dice = 0.0
        self.current_round = 0  # in global-iteration units
        self.history: List[Dict] = []

    def _local_clients(self) -> List[FederatedClient]:
        """The clients whose state lives in this process; a remote client
        (``transport.RemoteClientProxy``) keeps its state in its own."""
        return [c for c in self.clients if isinstance(c, FederatedClient)]

    def _resume_state(self) -> Dict:
        """Full restart state: server progress + the training state and ALA
        phase of every client held in this process. Saved with each
        periodic checkpoint."""
        return {
            "server": {"current_round": self.current_round, "best_dice": self.best_dice},
            "global": self.global_payload,
            "clients": {
                str(c.cid): {
                    "state": client_state_tree(c.state),
                    "start_phase": c.start_phase,
                    "ala_epochs": c._ala_epoch_counter,
                    "best_performance": c.best_performance,
                    "rng": c.generator.get_state(),
                }
                for c in self._local_clients()
            },
        }

    def try_resume(self) -> bool:
        """Restore a previous run's resume snapshot from the snapshot dir.
        Returns True when a snapshot was found and installed."""
        if not self.ckpt:
            return False
        device = self.clients[0].device if self.clients else None
        restored = self.ckpt.restore_resume(map_location=device)
        if restored is None:
            return False
        self.current_round = int(restored["server"]["current_round"])
        self.best_dice = float(restored["server"]["best_dice"])
        self.global_payload = restored["global"]
        for c in self._local_clients():
            rc = restored["clients"].get(str(c.cid))
            if rc is None:  # saved by a run whose client was remote
                continue
            st = rc["state"]
            c.state.generator.set_state(st["generator"].cpu())
            c.state = ClientState(st["params"], st["batch_stats"], int(st["current_iter"]),
                                  c.state.generator)
            c.start_phase = bool(rc["start_phase"])
            c._ala_epoch_counter = int(rc["ala_epochs"])
            c.best_performance = float(rc["best_performance"])
            c.generator.set_state(rc["rng"].cpu())
        print(
            f"[resume] restored run at iteration {self.current_round} "
            f"(best_dice {self.best_dice:.4f})",
            flush=True,
        )
        return True

    def fit_round(self, current_round: int) -> Optional[Dict[str, float]]:
        """One fit round. Returns None (round aborted, no aggregation) when
        any client fails: the reference's accept_failures=False semantics
        (..._Ours.py:377); a failed round never touches the global weights."""
        fit_config = {
            "iter_global": current_round,
            "iters": self.cfg.iters,
            "eval_iters": self.cfg.eval_iters,
            "batch_size": self.cfg.batch_size,
        }
        results = []
        for client in self.clients:
            try:
                res = client.fit(FitIns(self.global_payload, fit_config))
            except Exception as exc:  # dropped client / transport failure
                print(
                    f"[round {current_round}] client {client.cid} fit failed "
                    f"({type(exc).__name__}: {exc}); aborting round",
                    flush=True,
                )
                return None
            results.append(res)

        weights = [r.num_examples for r in results]
        new_payload = {}
        for part, tree in self.global_payload.items():
            if tree:  # the batch stats only when the model has any
                tree = self.strategy.aggregate(
                    tree, [r.payload[part] for r in results], weights, part=part
                )
            new_payload[part] = tree
        self.global_payload = new_payload
        metrics = {}
        for r in results:
            metrics.update(r.metrics)
            metrics["fit_duration"] = r.fit_duration
        # TB image grids (reference MyServer parity)
        for k in list(metrics):
            if "_vis_" in k and getattr(metrics[k], "ndim", 0) >= 2:
                self.writer.write_image(current_round, k, metrics.pop(k))
        return metrics

    def evaluate_round(self, current_round: int) -> Optional[Dict[str, float]]:
        """One evaluate round; None when any client fails (the reference's
        MyServer logs and continues, flower_common.py:303-306)."""
        eval_config = {"iter_global": current_round}
        all_metrics: Dict[str, float] = {}
        weights = {}
        for client in self.clients:
            try:
                res = client.evaluate(EvaluateIns(self.global_payload, eval_config))
            except Exception as exc:
                print(
                    f"[round {current_round}] client {client.cid} evaluate "
                    f"failed ({type(exc).__name__}: {exc}); skipping eval",
                    flush=True,
                )
                return None
            all_metrics.update(res.metrics)
            weights[client.cid] = res.num_examples

        # weighted + unweighted aggregates (flower_common.py:398-428)
        total = sum(weights.values())
        agg = {}
        for name in METRIC_NAMES:
            for ci in range(1, self.cfg.num_classes):
                agg[f"val_{ci}_{name}"] = sum(
                    weights[c.cid] * all_metrics[f"client_{c.cid}_val_{ci}_{name}"]
                    for c in self.clients
                ) / total
            agg[f"val_mean_{name}"] = sum(
                weights[c.cid] * all_metrics[f"client_{c.cid}_val_mean_{name}"]
                for c in self.clients
            ) / total
            agg[f"val_avg_mean_{name}"] = float(np.mean(
                [all_metrics[f"client_{c.cid}_val_mean_{name}"] for c in self.clients]
            ))
        all_metrics.update(agg)
        return all_metrics

    def run(self, num_rounds: Optional[int] = None, progress: bool = True, stop_fn=None):
        """Run the federated loop for ``num_rounds`` global iterations.

        ``stop_fn``: optional zero-arg callable polled at every round
        boundary; when it returns True the loop writes a resume snapshot and
        exits cleanly."""
        max_iters = num_rounds or self.cfg.max_iterations
        start = self.current_round + self.cfg.iters
        t0 = time.perf_counter()
        consecutive_failures = 0
        for current_round in range(start, max_iters + self.cfg.iters, self.cfg.iters):
            if stop_fn is not None and stop_fn():
                if self.ckpt:
                    self.ckpt.save_resume(self._resume_state())
                print(
                    f"[round {current_round}] stop requested; resume "
                    f"snapshot written at iteration {self.current_round}",
                    flush=True,
                )
                break
            round_t0 = time.perf_counter()
            fit_metrics = self.fit_round(current_round)
            self.current_round = current_round
            if fit_metrics is None:  # aborted round: log and continue
                self.history.append({"round": current_round, "aborted": True})
                consecutive_failures += 1
                if consecutive_failures >= self.cfg.max_consecutive_failures:
                    print(
                        f"[round {current_round}] {consecutive_failures} consecutive "
                        "aborted rounds; backend presumed dead, stopping the run",
                        flush=True,
                    )
                    break
                continue
            consecutive_failures = 0
            self.writer.write(current_round, fit_metrics)

            record = {"round": current_round, **fit_metrics}
            if current_round % self.cfg.eval_iters == 0:
                if self.central_eval_fn is not None:
                    try:
                        central = {
                            f"central_{k}": v
                            for k, v in self.central_eval_fn(self.global_payload).items()
                        }
                    except Exception as exc:
                        print(
                            f"[round {current_round}] central evaluate failed "
                            f"({type(exc).__name__}: {exc})",
                            flush=True,
                        )
                        central = {}
                    self.writer.write(current_round, central)
                    record.update(central)
                eval_metrics = self.evaluate_round(current_round) or {}
                self.writer.write(current_round, eval_metrics)
                record.update(eval_metrics)
                mean_dice = eval_metrics.get("val_mean_dice", 0.0)
                if mean_dice > self.best_dice:
                    self.best_dice = mean_dice
                    if self.ckpt:
                        self.ckpt.save_best(self.global_payload, current_round, mean_dice)
            if self.ckpt and current_round % self.cfg.ckpt_iters == 0:
                self.ckpt.save_periodic(self.global_payload, current_round)
                self.ckpt.save_resume(self._resume_state())
            record["round_duration"] = time.perf_counter() - round_t0
            self.history.append(record)
            if progress:
                msg = {
                    k: round(v, 4)
                    for k, v in record.items()
                    if isinstance(v, float) and ("total_loss" in k or "val_mean_dice" in k)
                }
                print(f"[round {current_round}] {msg}", flush=True)
            if current_round >= max_iters:
                break
        self.total_duration = time.perf_counter() - t0
        return self.history
