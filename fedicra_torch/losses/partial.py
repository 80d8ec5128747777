"""Partial (sparse-annotation) cross-entropy and Dice losses.

Counterpart of ``fedicra_tpu/losses/partial.py``. Logits and probabilities
are NHWC (B, H, W, C); labels are (B, H, W) integers in [0, num_classes],
where ``num_classes`` marks an unlabelled pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def partial_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean CE over the pixels whose label is not ``num_classes``; 0 if none is."""
    labels = labels.long()
    nll = F.cross_entropy(
        logits.permute(0, 3, 1, 2), labels, ignore_index=num_classes, reduction="sum"
    )
    return nll / (labels != num_classes).sum().clamp(min=1)


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
