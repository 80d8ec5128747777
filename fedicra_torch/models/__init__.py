from .factory import MODEL_TYPES, net_factory
from .unet import UNetLCMultiHead

__all__ = ["MODEL_TYPES", "UNetLCMultiHead", "net_factory"]
