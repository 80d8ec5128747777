from .factory import LC_MODELS, MODEL_TYPES, net_factory
from .unet import UNetLCMultiHead

__all__ = ["LC_MODELS", "MODEL_TYPES", "UNetLCMultiHead", "net_factory"]
