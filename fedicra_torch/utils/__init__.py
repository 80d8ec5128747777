from .checkpoint import CheckpointManager
from .logging import MetricsWriter

__all__ = ["CheckpointManager", "MetricsWriter"]
