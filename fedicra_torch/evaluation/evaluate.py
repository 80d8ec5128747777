"""Online validation: per-case inference + per-class metric aggregation.

Counterpart of ``fedicra_tpu/evaluation/evaluate.py`` (reference
val_2D.py:25-74, flower_common.py:122-151):
- eval-mode forward (running BN stats, no dropout), argmax over classes;
- per class i in 1..C-1: class 1 compares exact match (pred==1 vs gt==1),
  classes >= 2 compare the union (pred>=1 vs gt>=1), the ODOC cup/disc
  convention applied to every task (PARITY #12);
- per-client metric means over the val set; 7 metrics per class.

The JAX version pads the tail batch to one compiled shape; here the tail
batch runs as it is, which leaves the means unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from .metrics import METRIC_NAMES, metrics_percase


@torch.no_grad()
def predict_labels(model, params, batch_stats, images: torch.Tensor, emb_idx=None) -> torch.Tensor:
    """argmax prediction in eval mode. images [N, H, W, C] -> [N, H, W] int64.

    The weights are ``params`` / ``batch_stats`` (state_dict names); the
    model's own tensors are left as they are."""
    was_training = model.training
    model.eval()
    try:
        out = functional_call(model, {**params, **batch_stats}, (images,), {"emb_idx": emb_idx})
    finally:
        model.train(was_training)
    return torch.argmax(out["logits"], dim=-1)


def metrics_batch(preds: torch.Tensor, gts: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-case per-class metrics. preds/gts [N, H, W] -> [N, C-1, 7]."""
    rows = []
    for i in range(1, num_classes):
        if i == 1:
            rows.append(metrics_percase(preds == 1, gts == 1))
        else:
            rows.append(metrics_percase(preds >= 1, gts >= 1))
    return torch.stack(rows, 1)


def evaluate_client(
    model,
    params,
    batch_stats,
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    emb_idx: Optional[int] = None,
    batch: int = 8,
    device=None,
) -> Dict[str, float]:
    """Mean metrics over a client's val set (reference evaluate(),
    flower_common.py:122-137): per-case class-mean then case-mean."""
    device = resolve_device(device)
    n = images.shape[0]
    all_metrics = []
    for s in range(0, n, batch):
        img = torch.as_tensor(images[s:s + batch], device=device)
        gt = torch.as_tensor(labels[s:s + batch], device=device).long()
        emb = None
        if emb_idx is not None:
            emb = torch.full((img.shape[0],), emb_idx, dtype=torch.long, device=device)
        preds = predict_labels(model, params, batch_stats, img, emb_idx=emb)
        all_metrics.append(metrics_batch(preds, gt, num_classes).cpu().numpy())
    m = np.concatenate(all_metrics, axis=0)  # [N, C-1, 7]
    mean_per_class = m.mean(axis=0)  # [C-1, 7]
    out = {}
    for ci in range(mean_per_class.shape[0]):
        for mi, name in enumerate(METRIC_NAMES):
            out[f"class{ci + 1}_{name}"] = float(mean_per_class[ci, mi])
    for mi, name in enumerate(METRIC_NAMES):
        out[f"mean_{name}"] = float(mean_per_class[:, mi].mean())
    return out
