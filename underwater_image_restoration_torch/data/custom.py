"""The eval notebook's dataset variants, the port's own copy of the JAX
package's ``data/custom.py`` (numpy and PIL).

- ``U45Dataset``: unpaired inference set: sorted listing filtered by image
  extensions, resized; yields (image u8, idx).
- ``CustomImageDataset``: pairs across several directory pairs matched
  **by filename** (unlike UIEBDataset's sorted-order pairing; unmatched
  names are skipped), yielding the input, the reference at the input
  resolution, the reference at a second (higher) resolution, and idx.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .uieb import decode_image

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")


def _listing(d: str) -> List[str]:
    return sorted(f for f in os.listdir(d) if f.lower().endswith(_EXTS))


class U45Dataset:
    """(image_u8, idx) over one directory (eval.ipynb cell aa50e12f)."""

    def __init__(self, input_dir: str, image_size: int = 256):
        self.paths = [os.path.join(input_dir, f) for f in _listing(input_dir)]
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return decode_image(self.paths[idx], self.image_size), idx


class CustomImageDataset:
    """Filename-matched pairs across multiple dir pairs, with the reference
    decoded at two resolutions (eval.ipynb cell 2071afc9)."""

    def __init__(self, input_dirs: Sequence[str], reference_dirs: Sequence[str],
                 image_size: int = 256, image_size_high: int = 512):
        self.input_paths: List[str] = []
        self.reference_paths: List[str] = []
        for in_d, ref_d in zip(input_dirs, reference_dirs):
            ref_files = set(_listing(ref_d))
            for f in _listing(in_d):
                if f in ref_files:  # skip unmatched names (notebook behavior)
                    self.input_paths.append(os.path.join(in_d, f))
                    self.reference_paths.append(os.path.join(ref_d, f))
        self.image_size = image_size
        self.image_size_high = image_size_high

    def __len__(self) -> int:
        return len(self.input_paths)

    def __getitem__(self, idx: int):
        x = decode_image(self.input_paths[idx], self.image_size)
        ref_l = decode_image(self.reference_paths[idx], self.image_size)
        ref_h = decode_image(self.reference_paths[idx], self.image_size_high)
        return x, ref_l, ref_h, idx
