from .config import TASKS, TrainConfig

__all__ = ["TASKS", "TrainConfig"]
