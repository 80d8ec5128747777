from .dense_crf import dense_crf_loss, dense_crf_loss_lattice
from .gated_crf import gated_crf_features, gated_crf_loss, gated_crf_loss_auto
from .partial import partial_cross_entropy, partial_dice_loss
from .tree_energy import multi_scale_tree_energy_loss, tree_energy_loss

__all__ = [
    "dense_crf_loss",
    "dense_crf_loss_lattice",
    "gated_crf_features",
    "gated_crf_loss",
    "gated_crf_loss_auto",
    "multi_scale_tree_energy_loss",
    "partial_cross_entropy",
    "partial_dice_loss",
    "tree_energy_loss",
]
