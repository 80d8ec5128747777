"""The training objectives of the reference procedures, in PyTorch.

Counterpart of ``fedicra_tpu/engine/objective.py``.

"Ours": loss = pCE + MScaleRecurve tree energy (weight ``tree_loss_weight``)
              + ``gatecrf_weight`` * gated CRF + ``alpha`` * loss_lc,
with loss_lc = -(1/(K-1)) sum_{k != cid} MSE(own bottleneck PCS heatmap,
heatmap under client k's embedding, no gradient). At ``tree_loss_weight``
0 the tree term is skipped, as in the JAX package.

"pce": loss = pCE (+ alpha * loss_lc under FedICRA with an LC model).

"treeenergy_add": loss = pCE + MScaleAdd tree energy.

The objectives run the model in train mode and so advance its BatchNorm
running statistics in place, as the reference's torch code does; they
return ``(loss, metrics)``. Under AMP the terms keep the dtypes JAX gives
them: bf16 logits give a bf16 softmax, pCE and contrast term, the gated
CRF and the tree term come back fp32, and their sum is fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..losses.gated_crf import gated_crf_loss_auto
from ..losses.partial import partial_cross_entropy
from ..losses.tree_energy import multi_scale_tree_energy_loss
from ..models.factory import LC_MODELS
from ..ops.activations import softmax
from ..parallel.data_axis import batch_mean
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
    mses = []
    for k in range(K):
        if k == cid:
            continue
        emb = torch.full((batch,), cid if k == 0 else k, dtype=torch.long, device=images.device)
        with torch.no_grad():
            hm_k = model(images, emb_idx=emb, generator=generator)["heatmaps"][-1]
        mses.append(batch_mean((hm_own - hm_k) ** 2))
    # one sum in the heatmaps' dtype, as JAX's (bf16 under AMP)
    return -torch.stack(mses).sum() / (K - 1)


def _forward(model, images, cid, cfg: TrainConfig, generator):
    """The train-mode forward; only an LC model is given the client's embedding."""
    if cfg.model not in LC_MODELS:
        return model(images, generator=generator)
    emb = torch.full((images.shape[0],), cid, dtype=torch.long, device=images.device)
    return model(images, emb_idx=emb, generator=generator)


def _tree_loss(out, images, labels, cfg: TrainConfig, recursive: bool) -> torch.Tensor:
    """The multi-scale tree term on the unlabelled ROI, guided by the image
    (a 1-channel image repeated to 3 channels)."""
    unlabeled_rois = (labels == cfg.num_classes).float()
    three_channel = images.repeat(1, 1, 1, 3) if images.shape[-1] == 1 else images
    loss_tree, _, _, _ = multi_scale_tree_energy_loss(
        out["logits"], three_channel, *out["aux"], unlabeled_rois,
        cfg.tree_loss_weight, recursive=recursive,
    )
    return loss_tree


def ours_loss(
    model,
    batch: Dict[str, torch.Tensor],
    cid: int,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The FedICRA "Ours" objective; NHWC batch."""
    images, labels = batch["image"], batch["label"]
    out = _forward(model, images, cid, cfg, generator)
    logits = out["logits"]
    probs = softmax(logits, dim=-1)

    loss_ce = partial_cross_entropy(logits, labels, cfg.num_classes)
    if cfg.tree_loss_weight == 0.0:
        # The DSN heads still ran in train mode above (their running
        # statistics advance), but their outputs feed only the tree term.
        loss_tree = torch.zeros((), device=logits.device)
    else:
        loss_tree = _tree_loss(out, images, labels, cfg, recursive=True)
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
    """pCE-only objective, + the contrast term under FedICRA with an LC
    model; NHWC batch."""
    images, labels = batch["image"], batch["label"]
    out = _forward(model, images, cid, cfg, generator)
    loss_ce = partial_cross_entropy(out["logits"], labels, cfg.num_classes)
    loss = loss_ce
    metrics = {"loss_ce": loss_ce}
    if cfg.fedicra and cfg.model in LC_MODELS:
        loss_lc = _contrast_loss(model, images, out["heatmaps"][-1], cid, cfg, generator)
        loss = loss + cfg.alpha * loss_lc
        metrics["loss_lc"] = loss_lc
    metrics["total_loss"] = loss
    return loss, metrics


def treeenergy_add_loss(
    model,
    batch: Dict[str, torch.Tensor],
    cid: int,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pCE + the additive multi-scale tree term (no contrast term); NHWC batch."""
    images, labels = batch["image"], batch["label"]
    out = _forward(model, images, cid, cfg, generator)
    loss_ce = partial_cross_entropy(out["logits"], labels, cfg.num_classes)
    loss_tree = _tree_loss(out, images, labels, cfg, recursive=False)
    loss = loss_ce + loss_tree
    return loss, {"loss_ce": loss_ce, "loss_tree": loss_tree, "total_loss": loss}


def get_objective(cfg: TrainConfig):
    objectives = {"ours": ours_loss, "pce": pce_loss, "treeenergy_add": treeenergy_add_loss}
    if cfg.procedure not in objectives:
        raise ValueError(cfg.procedure)
    return objectives[cfg.procedure]
