"""Tree energy losses: single-scale, multi-scale additive and recursive.

Counterpart of ``fedicra_tpu/losses/tree_energy.py``, NHWC at the public
functions as there:

- ``tree_energy_loss``: the low-level MST of the guide image (sigma 0.02)
  filters the softmax probabilities into soft pseudo-labels AS, refined
  once through a high-level tree when aux logits are given;
  loss = weight * sum(ROI * |prob - AS|) / sum(ROI).
- ``multi_scale_tree_energy_loss``: three high-level trees, from the three
  aux logits upsampled to the logits' size. Recursive (the "Ours" loss):
  AS -> AS_1 -> AS_2 -> AS_3, loss on AS_3. Additive: each tree filters
  the same AS and the loss sums the three terms.

MST edge weights are ||dfeat||^2 + 1 and get no gradient. The filter
weights are exp(-||dfeat||^2 / sigma) on the low tree (no gradient) and
exp(-||dfeat||^2) on high trees (gradient to the aux logits).

The JAX package runs one image at a time under vmap and, on the TPU, moves
the chain to host C++. Here every stage runs batched on the tensors'
device, and the low tree and the high trees are built in one batched MST
and one batched Euler tour: they are independent; only the filters chain.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.activations import softmax
from ..ops.mst import boruvka_mst, grid_edges
from ..ops.tree import TreeStructure, build_tree
from ..ops.tree_filter import tree_filter
from ..parallel.data_axis import batch_count


def resize_linear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` on NHWC: half-pixel centres, and
    an antialiasing triangle filter wherever it shrinks."""
    h, w = x.shape[1:3]
    if (h, w) == tuple(hw):
        return x
    out = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
        align_corners=False, antialias=hw[0] < h or hw[1] < w,
    )
    return out.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` on NHWC (torch's "nearest-exact")."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest-exact")
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def mst_edge_weights(guides: Sequence[torch.Tensor], eu: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """MST edge weights ||dfeat||^2 + 1 over the edges (eu, ev) of each guide
    [B, H, W, D_k], stacked guide after guide: [K * B, E]."""
    b, h, w = guides[0].shape[:3]
    flats = [g.reshape(b, h * w, -1) for g in guides]
    return torch.cat([torch.sum((f[:, eu] - f[:, ev]) ** 2, dim=-1) + 1.0 for f in flats])


def mst_structures(guides: Sequence[torch.Tensor]) -> Tuple[TreeStructure, ...]:
    """One tree per guide [B, H, W, D_k], from one batched MST and Euler tour."""
    b, h, w = guides[0].shape[:3]
    V = h * w
    eu, ev = (torch.as_tensor(a, device=guides[0].device).long() for a in grid_edges(h, w))
    dist = mst_edge_weights(guides, eu, ev)
    struct = build_tree(eu, ev, boruvka_mst(eu, ev, dist, V), V)
    return tuple(TreeStructure(*(t[k * b:(k + 1) * b] for t in struct)) for k in range(len(guides)))


def _filter_image(feature, embed, struct, *, sigma, low_tree):
    """feature, embed: [B, H, W, C]; filter over the trees, back to NHWC."""
    b, h, w, c = feature.shape
    out = tree_filter(
        feature.reshape(b, h * w, c), embed.reshape(b, h * w, -1), struct,
        sigma=sigma, low_tree=low_tree,
    )
    return out.reshape(b, h, w, c)


def filter_chain(prob, low, highs, *, sigma: float, recursive: bool):
    """The low-level filter, then the chain (or fan) of high-level ones.

    Returns (AS, [AS_1, ...]); all tensors NHWC.
    """
    structs = mst_structures([low, *highs])
    AS = _filter_image(prob, low, structs[0], sigma=sigma, low_tree=True)
    outs, cur = [], AS
    for hf, st in zip(highs, structs[1:]):
        cur = _filter_image(cur if recursive else AS, hf, st, sigma=sigma, low_tree=False)
        outs.append(cur)
    return AS, outs


def _prep(preds, low_feats, unlabeled_rois):
    h, w = preds.shape[1:3]
    low = resize_linear(low_feats, (h, w)).detach()
    rois = resize_nearest(unlabeled_rois[..., None].to(preds.dtype), (h, w))
    return softmax(preds, dim=-1), low, rois


def _roi_normalised(loss: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """``loss`` over the ROI's size (the whole client batch's under a data shard)."""
    n = batch_count(rois.sum())
    return torch.where(n > 0, loss / n.clamp(min=1.0), loss)


def _roi_l1(prob, AS, rois):
    return _roi_normalised(torch.sum(rois * torch.abs(prob - AS)), rois)


def tree_energy_loss(
    preds: torch.Tensor,
    low_feats: torch.Tensor,
    high_feats: Optional[torch.Tensor],
    unlabeled_rois: torch.Tensor,
    weight: float,
    *,
    sigma: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-scale tree energy loss; returns (loss, AS).

    preds: logits [B, H, W, C]; low_feats: guide image [B, h, w, D];
    high_feats: aux logits or None; unlabeled_rois: [B, H, W].
    """
    h, w = preds.shape[1:3]
    prob, low, rois = _prep(preds, low_feats, unlabeled_rois)
    highs = [] if high_feats is None else [resize_linear(high_feats, (h, w))]
    AS, outs = filter_chain(prob, low, highs, sigma=sigma, recursive=True)
    AS = outs[-1] if outs else AS
    return weight * _roi_l1(prob, AS, rois), AS


def multi_scale_tree_energy_loss(
    preds: torch.Tensor,
    low_feats: torch.Tensor,
    aux1: torch.Tensor,
    aux2: torch.Tensor,
    aux3: torch.Tensor,
    unlabeled_rois: torch.Tensor,
    weight: float,
    *,
    sigma: float = 0.02,
    recursive: bool = True,
):
    """MScaleRecurve (``recursive=True``) or MScaleAdd tree energy loss.

    Returns (loss, AS_1, AS_2, AS_3).
    """
    h, w = preds.shape[1:3]
    prob, low, rois = _prep(preds, low_feats, unlabeled_rois)
    highs = [resize_linear(a, (h, w)) for a in (aux1, aux2, aux3)]
    _, (AS_1, AS_2, AS_3) = filter_chain(prob, low, highs, sigma=sigma, recursive=recursive)
    if recursive:
        loss = _roi_l1(prob, AS_3, rois)
    else:
        total = sum(torch.sum(rois * torch.abs(prob - a)) for a in (AS_1, AS_2, AS_3))
        loss = _roi_normalised(total, rois)
    return weight * loss, AS_1, AS_2, AS_3
