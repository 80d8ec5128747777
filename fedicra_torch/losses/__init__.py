from .gated_crf import gated_crf_features, gated_crf_loss, gated_crf_loss_auto
from .partial import partial_cross_entropy, partial_dice_loss

__all__ = [
    "gated_crf_features",
    "gated_crf_loss",
    "gated_crf_loss_auto",
    "partial_cross_entropy",
    "partial_dice_loss",
]
