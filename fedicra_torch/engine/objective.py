"""The training objectives of the reference procedures, in PyTorch.

Counterpart of ``fedicra_tpu/engine/objective.py``.

"Ours": loss = pCE + tree energy (weight ``tree_loss_weight``)
              + ``gatecrf_weight`` * gated CRF + ``alpha`` * loss_lc,
with loss_lc = -(1/(K-1)) sum_{k != cid} MSE(own bottleneck PCS heatmap,
heatmap under client k's embedding, no gradient).

The tree-energy term is not ported yet: ``ours_loss`` takes
``tree_loss_weight == 0`` only (ROADMAP.md, slice 2), where the JAX package
skips the tree computation too.

"pce": loss = pCE (+ alpha * loss_lc under FedICRA).

The objectives run the model in train mode and so advance its BatchNorm
running statistics in place, as the reference's torch code does; they
return ``(loss, metrics)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..losses.gated_crf import gated_crf_loss_auto
from ..losses.partial import partial_cross_entropy
from .config import TrainConfig


def _contrast_loss(
    model,
    images: torch.Tensor,
    hm_own: torch.Tensor,
    cid: int,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """FedICRA cross-client heatmap contrast, as the reference's sequential loop.

    One no-grad train-mode forward per foreign client k != cid, in order,
    each advancing the BatchNorm running statistics in turn. The k == 0
    forward uses the *own* cid (the reference's ``emb_idx`` falsy quirk).
    The forwards are not batched into one K*B batch: that would pool their
    BatchNorm statistics.
    """
    K = cfg.num_clients
    batch = images.shape[0]
    total = hm_own.new_zeros(())
    for k in range(K):
        if k == cid:
            continue
        emb = torch.full((batch,), cid if k == 0 else k, dtype=torch.long, device=images.device)
        with torch.no_grad():
            hm_k = model(images, emb_idx=emb, generator=generator)["heatmaps"][-1]
        total = total + torch.mean((hm_own - hm_k) ** 2)
    return -total / (K - 1)


def _forward(model, images, cid, generator):
    emb = torch.full((images.shape[0],), cid, dtype=torch.long, device=images.device)
    return model(images, emb_idx=emb, generator=generator)


def ours_loss(
    model,
    batch: Dict[str, torch.Tensor],
    cid: int,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The FedICRA "Ours" objective with the tree term off; NHWC batch."""
    if cfg.tree_loss_weight != 0.0:
        raise NotImplementedError(
            "the tree-energy term is not ported yet (ROADMAP.md, slice 2); "
            "set tree_loss_weight=0.0"
        )
    images, labels = batch["image"], batch["label"]
    out = _forward(model, images, cid, generator)
    logits = out["logits"]
    probs = torch.softmax(logits, dim=-1)

    loss_ce = partial_cross_entropy(logits, labels, cfg.num_classes)
    # The DSN heads still ran in train mode above (their running statistics
    # advance), but their outputs feed only the tree term.
    loss_tree = logits.new_zeros(())
    loss_crf = gated_crf_loss_auto(probs, images, radius=cfg.gatecrf_radius)
    loss = loss_ce + loss_tree + cfg.gatecrf_weight * loss_crf
    metrics = {"loss_ce": loss_ce, "loss_tree": loss_tree, "loss_crf": loss_crf}

    if cfg.fedicra:
        loss_lc = _contrast_loss(model, images, out["heatmaps"][-1], cid, cfg, generator)
        loss = loss + cfg.alpha * loss_lc
        metrics["loss_lc"] = loss_lc

    metrics["total_loss"] = loss
    vis_idx = min(1, logits.shape[0] - 1)
    metrics["vis_pred"] = torch.argmax(logits[vis_idx], dim=-1).int()
    return loss, metrics


def pce_loss(
    model,
    batch: Dict[str, torch.Tensor],
    cid: int,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pCE-only objective, + the contrast term under FedICRA; NHWC batch."""
    images, labels = batch["image"], batch["label"]
    out = _forward(model, images, cid, generator)
    loss_ce = partial_cross_entropy(out["logits"], labels, cfg.num_classes)
    loss = loss_ce
    metrics = {"loss_ce": loss_ce}
    if cfg.fedicra:
        loss_lc = _contrast_loss(model, images, out["heatmaps"][-1], cid, cfg, generator)
        loss = loss + cfg.alpha * loss_lc
        metrics["loss_lc"] = loss_lc
    metrics["total_loss"] = loss
    return loss, metrics


def get_objective(cfg: TrainConfig):
    if cfg.procedure == "ours":
        return ours_loss
    if cfg.procedure == "pce":
        return pce_loss
    raise NotImplementedError(
        f"procedure {cfg.procedure!r} is not ported yet (ROADMAP.md, slice 2)"
    )
