from .augment import augment_batch, augment_sample, image_cval_for
from .batcher import EpochBatcher
from .h5io import ClientSplit, load_client_split, make_synthetic_split

__all__ = [
    "augment_batch",
    "augment_sample",
    "image_cval_for",
    "EpochBatcher",
    "ClientSplit",
    "load_client_split",
    "make_synthetic_split",
]
