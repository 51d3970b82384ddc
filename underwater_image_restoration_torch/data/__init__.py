"""Data of the port: UIEB-style paired directories (sorted listings), a
deterministic checkpointable prefetching loader of uint8 NHWC batches,
online pair-consistent augmentation, a decoded-image cache, the dataset
manager, synthetic pairs, the eval notebook's U45 and filename-matched
datasets, and the offline augmentor."""
from .augment import AugmentConfig, augment_pair_batch
from .custom import CustomImageDataset, U45Dataset
from .loader import Batch, PairedLoader, get_dataloaders
from .manager import DataManager
from .offline_augment import DataAugmentor
from .synthetic import synthetic_pair_batch
from .uieb import UIEBDataset, decode_image, load_pair_listing

__all__ = [
    "AugmentConfig",
    "Batch",
    "CustomImageDataset",
    "DataAugmentor",
    "DataManager",
    "PairedLoader",
    "U45Dataset",
    "UIEBDataset",
    "augment_pair_batch",
    "decode_image",
    "get_dataloaders",
    "load_pair_listing",
    "synthetic_pair_batch",
]
