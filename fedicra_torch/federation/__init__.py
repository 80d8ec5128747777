from .api import EvaluateIns, EvaluateRes, FitIns, FitRes
from .client import FederatedClient
from .experiment import build_experiment, load_task_splits
from .server import FederatedServer
from .strategies import (
    CENTRALIZED_FL,
    PERSONALIZED_FL,
    FedAdagrad,
    FedAdam,
    FedAvg,
    FedICRA,
    FedYogi,
    get_strategy,
    weighted_tree_mean,
)

__all__ = [
    "EvaluateIns",
    "EvaluateRes",
    "FitIns",
    "FitRes",
    "FederatedClient",
    "build_experiment",
    "load_task_splits",
    "FederatedServer",
    "CENTRALIZED_FL",
    "PERSONALIZED_FL",
    "FedAdagrad",
    "FedAdam",
    "FedAvg",
    "FedICRA",
    "FedYogi",
    "get_strategy",
    "weighted_tree_mean",
]
