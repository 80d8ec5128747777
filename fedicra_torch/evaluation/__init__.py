from .evaluate import evaluate_client, metrics_batch, predict_labels
from .metrics import METRIC_NAMES, metrics_percase, surface_distances
from .uncertainty import batch_uncertainty, draw_uncertainty, evaluate_uncertainty

__all__ = [
    "batch_uncertainty",
    "draw_uncertainty",
    "evaluate_client",
    "evaluate_uncertainty",
    "metrics_batch",
    "predict_labels",
    "METRIC_NAMES",
    "metrics_percase",
    "surface_distances",
]
