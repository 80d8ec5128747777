from .evaluate import evaluate_client, metrics_batch, predict_labels
from .metrics import METRIC_NAMES, metrics_percase, surface_distances

__all__ = [
    "evaluate_client",
    "metrics_batch",
    "predict_labels",
    "METRIC_NAMES",
    "metrics_percase",
    "surface_distances",
]
