"""Data of the port: UIEB-style paired directories (sorted listings), a
deterministic checkpointable prefetching loader of uint8 NHWC batches,
online pair-consistent augmentation, a decoded-image cache, the dataset
manager, and synthetic pairs."""
from .augment import AugmentConfig, augment_pair_batch
from .loader import Batch, PairedLoader, get_dataloaders
from .manager import DataManager
from .synthetic import synthetic_pair_batch
from .uieb import UIEBDataset, decode_image, load_pair_listing

__all__ = [
    "AugmentConfig",
    "Batch",
    "DataManager",
    "PairedLoader",
    "UIEBDataset",
    "augment_pair_batch",
    "decode_image",
    "get_dataloaders",
    "load_pair_listing",
    "synthetic_pair_batch",
]
