"""UIEB paired dataset and image decode, the port's own copy of the JAX
package's ``data/uieb.py`` (``load_pair_listing``, ``UIEBDataset``,
``decode_image``).

Pairing is by *sorted directory listing* on each side, exactly like the
reference (UIEBDataset.py:10-11): file names need not match, only sorted
order.  Decode is PIL -> RGB -> bilinear resize -> uint8 HWC numpy.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def load_pair_listing(raw_dir: str, ref_dir: str) -> Tuple[List[str], List[str]]:
    raw = sorted(os.listdir(raw_dir))
    ref = sorted(os.listdir(ref_dir))
    return (
        [os.path.join(raw_dir, f) for f in raw],
        [os.path.join(ref_dir, f) for f in ref],
    )


def decode_image(path: str, size: Optional[int]) -> np.ndarray:
    """PIL open -> RGB -> bilinear resize to (size, size) -> uint8 HWC.

    PIL is imported here, not at module import: the serving path needs it
    only when it decodes files."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None and im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


class UIEBDataset:
    """Paired raw/reference dataset; __getitem__ -> (raw u8 HWC, ref u8 HWC)."""

    def __init__(self, raw_dir: str, ref_dir: str, image_size: Optional[int] = 1024):
        self.raw_paths, self.ref_paths = load_pair_listing(raw_dir, ref_dir)
        if len(self.raw_paths) != len(self.ref_paths):
            # the reference silently indexes past the shorter list; fail loudly
            raise ValueError(
                f"unpaired listing: {len(self.raw_paths)} raw vs "
                f"{len(self.ref_paths)} ref images"
            )
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.raw_paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return (
            decode_image(self.raw_paths[idx], self.image_size),
            decode_image(self.ref_paths[idx], self.image_size),
        )
