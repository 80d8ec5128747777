"""Segmentation metrics in PyTorch (medpy.metric.binary semantics).

Counterpart of ``fedicra_tpu/evaluation/metrics.py``: the reference's 7
online metrics per class (['dice','hd95','recall','precision','jc',
'specificity','ravd'], flower_common.py:121, val_2D.py:9-22). Every function
takes binary masks with any leading batch dimensions, [..., H, W], and runs
on the masks' device.

- Overlap metrics are confusion-count expressions.
- Surface metrics (hd95 / asd / assd) read each mask's exact Euclidean
  distance transform at the other mask's boundary pixels, a boundary being
  the mask minus its 4-connected erosion with zero padding (medpy's). The
  EDT is separable: per-row distances to the nearest boundary pixel from a
  running max of boundary indices from the left and from the right, then the
  column min-plus d2[y, x] = min_y' (rowdist[y', x]^2 + (y - y')^2) in chunks
  of columns. Every term is an integer below 2^24, so it is exact in float32,
  as JAX's is.

Reference quirk reproduced (val_2D.py:67-73): when a prediction is empty,
every metric is 0. Where the other mask has no boundary, its distances are
inf, so asd and assd are inf and hd95, numpy's linear percentile of them, is
NaN (inf - inf), as in the JAX version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

METRIC_NAMES = ("dice", "hd95", "recall", "precision", "jc", "specificity", "ravd")

_EDT_INF = 1e9  # "no boundary in this row" sentinel; 1e9^2 = 1e18 << f32 max


def _counts(pred: torch.Tensor, gt: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    pred, gt = pred.float(), gt.float()
    dims = (-2, -1)
    tp = torch.sum(pred * gt, dims)
    fp = torch.sum(pred * (1 - gt), dims)
    fn = torch.sum((1 - pred) * gt, dims)
    tn = torch.sum((1 - pred) * (1 - gt), dims)
    return tp, fp, fn, tn


def dice(pred, gt):
    tp, fp, fn, _ = _counts(pred, gt)
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1e-8)


def jaccard(pred, gt):
    tp, fp, fn, _ = _counts(pred, gt)
    return tp / torch.clamp(tp + fp + fn, min=1e-8)


def recall(pred, gt):
    tp, _, fn, _ = _counts(pred, gt)
    return tp / torch.clamp(tp + fn, min=1e-8)


def precision(pred, gt):
    tp, fp, _, _ = _counts(pred, gt)
    return tp / torch.clamp(tp + fp, min=1e-8)


def specificity(pred, gt):
    _, fp, _, tn = _counts(pred, gt)
    return tn / torch.clamp(tn + fp, min=1e-8)


def ravd(pred, gt):
    """medpy ravd: (|pred| - |gt|) / |gt| (result vs reference volumes)."""
    vp = torch.sum(pred.float(), (-2, -1))
    vg = torch.sum(gt.float(), (-2, -1))
    return (vp - vg) / torch.clamp(vg, min=1e-8)


def _boundary(mask: torch.Tensor) -> torch.Tensor:
    """mask ^ erosion(mask) with the 4-connected cross, zero padding outside."""
    m = mask.bool()
    p = torch.nn.functional.pad(m, (1, 1, 1, 1), value=False)
    er = (
        p[..., 1:-1, 1:-1]
        & p[..., :-2, 1:-1]
        & p[..., 2:, 1:-1]
        & p[..., 1:-1, :-2]
        & p[..., 1:-1, 2:]
    )
    return m & ~er


def _row_dist(b: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = min_x' |x - x'| over b[..., y, x'] (_EDT_INF if none)."""
    w = b.shape[-1]
    xs = torch.arange(w, device=b.device)
    far = 2 * w  # an index farther than w from every pixel
    last = torch.cummax(torch.where(b, xs, -far), dim=-1).values  # nearest at or left of x
    nxt = torch.cummin(torch.where(b, xs, far).flip(-1), dim=-1).values.flip(-1)  # at or right
    dist = torch.minimum(xs - last, nxt - xs)
    return dist.float().masked_fill(dist > w, _EDT_INF)


def _edt(b: torch.Tensor, col_chunk: int = 48) -> torch.Tensor:
    """Exact Euclidean distance transform to the True set of ``b`` [..., H, W]."""
    h, w = b.shape[-2:]
    g2 = _row_dist(b) ** 2
    ys = torch.arange(h, dtype=torch.float32, device=b.device)
    dy2 = (ys[:, None] - ys[None, :]) ** 2  # (H_out, H_in)
    cols = []
    for lo in range(0, w, col_chunk):
        gc = g2[..., lo:lo + col_chunk]  # [..., H_in, chunk]
        cols.append(torch.amin(dy2[:, :, None] + gc[..., None, :, :], dim=-2))
    return torch.sqrt(torch.cat(cols, dim=-1))


def _masked_percentile(vals: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """numpy 'linear' percentile over the valid entries of the last axis,
    in float32 as the JAX version computes it."""
    n = valid.sum(-1)
    sorted_vals = torch.sort(torch.where(valid, vals, torch.full_like(vals, float("inf"))), -1).values
    pos = (q / 100.0) * (n.float() - 1.0)
    last = vals.shape[-1] - 1
    lo = torch.clamp(torch.floor(pos).long(), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.float()
    v_lo = sorted_vals.gather(-1, lo[..., None])[..., 0]
    v_hi = torch.where(hi < n, sorted_vals.gather(-1, hi[..., None])[..., 0], v_lo)
    return v_lo + frac * (v_hi - v_lo)


def _masked_mean(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    total = torch.sum(torch.where(valid, vals, torch.zeros_like(vals)), -1)
    return total / torch.clamp(valid.sum(-1), min=1)


def surface_distances(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """hd95 / asd / assd between binary masks [..., H, W], medpy conventions.

    hd95: 95th percentile of the concatenated symmetric surface distances;
    assd: mean of the concatenated distances; asd: mean pred->gt distance.
    Every boundary pixel takes part."""
    bp, bg = _boundary(pred), _boundary(gt)
    inf = torch.tensor(float("inf"), device=bp.device)
    flat = bp.shape[:-2] + (-1,)
    dg = torch.where(bg.flatten(-2).any(-1)[..., None, None], _edt(bg), inf).reshape(flat)
    dp = torch.where(bp.flatten(-2).any(-1)[..., None, None], _edt(bp), inf).reshape(flat)
    m_ab, m_ba = bp.reshape(flat), bg.reshape(flat)
    both = torch.cat([dg, dp], -1)
    both_m = torch.cat([m_ab, m_ba], -1)
    return {
        "hd95": _masked_percentile(both, both_m, 95.0),
        "asd": _masked_mean(dg, m_ab),
        "assd": _masked_mean(both, both_m),
    }


def metrics_percase(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The reference's calculate_metric_percase (val_2D.py:9-22): the 7
    metrics on the last axis of the result, all 0 where the prediction is
    empty. pred/gt are binary [..., H, W]."""
    pred, gt = (pred > 0).float(), (gt > 0).float()
    sd = surface_distances(pred, gt)
    vals = torch.stack(
        [
            dice(pred, gt),
            sd["hd95"],
            recall(pred, gt),
            precision(pred, gt),
            jaccard(pred, gt),
            specificity(pred, gt),
            ravd(pred, gt),
        ],
        -1,
    )
    nonempty = pred.sum((-2, -1)) > 0
    return torch.where(nonempty[..., None], vals, torch.zeros_like(vals))
