"""Partial (sparse-annotation) cross-entropy and Dice losses.

Counterpart of ``fedicra_tpu/losses/partial.py``. Logits and probabilities
are NHWC (B, H, W, C); labels are (B, H, W) integers in [0, num_classes],
where ``num_classes`` marks an unlabelled pixel.
"""

from __future__ import annotations

import torch

from ..ops.activations import log_softmax
from ..parallel.data_axis import batch_count


def partial_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean CE over the pixels whose label is not ``num_classes``; 0 if none is.

    Written as JAX's is, so it rounds where JAX does in the logits' dtype
    (bf16 under AMP): each step of the log-softmax, the per-pixel loss, its
    sum (taken in fp32 and rounded once) and the division by the count.
    Under a data shard the count is the whole client batch's.
    """
    valid = labels != num_classes
    safe = torch.where(valid, labels, 0).long()
    nll = -log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / batch_count(valid.sum()).clamp(min=1)


def partial_dice_loss(probs: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """1 - soft Dice per class under the ignore mask, averaged over classes."""
    smooth = 1e-5
    ignore_mask = (labels != num_classes).to(probs.dtype)
    loss = probs.new_zeros(())
    for i in range(num_classes):
        target = (labels == i).to(probs.dtype)
        score = probs[..., i]
        intersect = torch.sum(score * target * ignore_mask)
        y_sum = torch.sum(target * target * ignore_mask)
        z_sum = torch.sum(score * score * ignore_mask)
        dice = (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
        loss = loss + (1.0 - dice)
    return loss / num_classes
