"""Federated client: the in-process counterpart of the reference BaseClient.

Counterpart of ``fedicra_tpu/federation/client.py``.

fit  = set_weights (ALA merge for FedICRA) -> local train round -> weights
       (flower_common.py:60-81)
evaluate = set_weights -> per-client validation (+ own-best checkpoint)
       (flower_common.py:83-118). The reference runs the *full* set_weights,
       including another ALA merge, on every evaluate call, and the merged
       weights persist into the next fit; reproduced here.

num_examples in FitRes is the client's batch count (len(trainloader)), the
reference's FedAvg weighting quirk (flower_common.py:72, PARITY #6).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..data.batcher import EpochBatcher
from ..data.h5io import ClientSplit
from ..device import resolve_device
from ..engine.config import TrainConfig
from ..engine.trainer import ClientState
from ..evaluation.evaluate import evaluate_client
from .ala import ala_set_weights
from .api import EvaluateIns, EvaluateRes, FitIns, FitRes


def val_metrics(m: Dict[str, float]) -> Dict[str, float]:
    """``evaluate_client``'s names as the reference logs them:
    ``classN_metric`` -> ``val_N_metric``, ``mean_metric`` -> ``val_mean_metric``."""
    out = {}
    for k, v in m.items():
        if k.startswith("mean_"):
            out[f"val_mean_{k[5:]}"] = v
        else:
            cls, name = k.split("_", 1)
            out[f"val_{cls[5:]}_{name}"] = v
    return out


def copy_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device, at the same point of its stream."""
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


class FederatedClient:
    def __init__(
        self,
        cid: int,
        cfg: TrainConfig,
        model,
        train_split: ClientSplit,
        val_split: ClientSplit,
        round_fn: Callable,
        init_state: ClientState,
        ckpt=None,
        device=None,
    ):
        self.cid = cid
        self.cfg = cfg
        self.model = model
        self.round_fn = round_fn
        self.device = resolve_device(device)
        # every client starts from the same weights and dropout stream
        self.state = ClientState(
            init_state.params, init_state.batch_stats, init_state.current_iter,
            copy_generator(init_state.generator),
        )
        self.batcher = EpochBatcher(
            train_split, cfg.batch_size, cfg.num_classes, cfg.img_class,
            seed=cfg.seed * 1000 + cid, device=self.device,
        )
        # ALA iterates the dataloader afresh (new shuffle and augmentation
        # per epoch), a stream apart from the training batches, over the
        # train batcher's device copy of the data
        self._ala_batcher = EpochBatcher(
            train_split, cfg.batch_size, cfg.num_classes, cfg.img_class,
            seed=cfg.seed * 1000 + 500 + cid, source=self.batcher,
        )
        self._ala_epoch_counter = 0
        self.ala_report: dict = {}  # the last ALA merge's epochs, losses, gate mean
        self.val_split = val_split
        self.start_phase = True
        self.best_performance = 0.0
        # client-side own-best checkpointing (flower_common.py:106-114):
        # saved from evaluate() whenever THIS client's val_mean_dice improves
        self.ckpt = ckpt
        # ALA's dropout stream (the JAX client's _rng)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed * 7919 + cid)

    @property
    def num_batches(self) -> int:
        return self.batcher.num_batches

    def _set_weights(self, payload, config):
        """ALA merge under FedICRA; plain adoption otherwise."""
        if self.cfg.fedicra:
            def batch_provider(_epoch):
                self._ala_epoch_counter += 1
                imgs, labs = self._ala_batcher.epoch_arrays(self._ala_epoch_counter)
                return {"image": imgs, "label": labs}

            self.ala_report = {}
            params, stats, self.start_phase = ala_set_weights(
                self.model,
                self.cfg,
                self.state.params,
                payload["params"],
                payload["batch_stats"],
                batch_provider,
                self.generator,
                self.cid,
                int(config.get("iter_global", 0)),
                self.start_phase,
                report=self.ala_report,
            )
            # free the ALA stream's epoch until the next merge (rebuilt
            # from its seed)
            self._ala_batcher.drop_epoch_cache()
        else:
            params, stats = payload["params"], payload["batch_stats"]
        self.state = ClientState(params, stats, self.state.current_iter, self.state.generator)

    def fit(self, ins: FitIns) -> FitRes:
        t0 = time.perf_counter()
        self._set_weights(ins.payload, ins.config)
        start_iter = int(self.state.current_iter)
        batches = self.batcher.batches_for_round(start_iter, self.cfg.iters)
        self.state, metrics = self.round_fn(self.state, batches, self.cid)
        scalar_metrics = {}
        for k, v in metrics.items():
            v = v.detach().cpu()
            arr = (v.float() if v.is_floating_point() else v).numpy()  # numpy has no bf16
            if arr.ndim <= 1:
                scalar_metrics[f"client_{self.cid}_{k}"] = float(arr[-1])
            else:  # per-iter arrays (vis_pred): keep the last iteration
                scalar_metrics[f"client_{self.cid}_{k}"] = arr[-1]
        # visualisation parity: ship input/GT of the logged sample alongside
        vis_idx = min(1, self.cfg.batch_size - 1)
        scalar_metrics[f"client_{self.cid}_vis_image"] = batches["image"][-1, vis_idx].cpu().numpy()
        scalar_metrics[f"client_{self.cid}_vis_gt"] = batches["label"][-1, vis_idx].cpu().numpy()
        # one client's epoch on the device at a time (rebuilt from its seed)
        del batches
        self.batcher.drop_epoch_cache()
        return FitRes(
            payload={"params": self.state.params, "batch_stats": self.state.batch_stats},
            num_examples=self.num_batches,
            metrics=scalar_metrics,
            fit_duration=time.perf_counter() - t0,
        )

    def evaluate(self, ins: EvaluateIns) -> EvaluateRes:
        self._set_weights(ins.payload, ins.config)
        m = evaluate_client(
            self.model,
            self.state.params,
            self.state.batch_stats,
            self.val_split.images,
            self.val_split.labels,
            self.cfg.num_classes,
            emb_idx=self.cid,
            device=self.device,
        )
        val = val_metrics(m)
        new_best = val["val_mean_dice"] > self.best_performance
        if new_best:
            self.best_performance = val["val_mean_dice"]
            if self.ckpt is not None:
                # the client persists ITS OWN state at ITS OWN best val dice,
                # right after set_weights + validate: self.state holds exactly
                # the evaluated (ALA-merged) model
                self.ckpt.save_client_best(
                    self.cid, self.state, int(ins.config.get("iter_global", 0)),
                    self.best_performance,
                )
        prefixed = {f"client_{self.cid}_{k}": v for k, v in val.items()}
        prefixed[f"client_{self.cid}_new_best"] = float(new_best)
        return EvaluateRes(loss=0.0, num_examples=len(self.val_split), metrics=prefixed)
