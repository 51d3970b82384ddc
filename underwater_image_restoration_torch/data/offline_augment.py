"""Offline augmentation (reference ``DataAugmentor.py:10-154``), the port's
own copy of the JAX package's ``data/offline_augment.py`` over the port's
``data/augment.py``.

Loads a directory of images and writes N augmented copies of each as
``<stem>_aug<i><ext>``, drawn from ``default_rng((seed, file index,
augmentation index))``.  Paired directories are augmented consistently
(the same geometric ops on raw and reference from the shared draw).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .augment import AugmentConfig, augment_pair_batch
from .uieb import decode_image

class DataAugmentor:
    """Reference-compatible surface: construct with source/target dirs, call
    ``apply_augmentations(num_augmentations_per_image)`` then
    ``save_augmented_images()`` (DataAugmentor.py:100-154)."""

    def __init__(self, source_directory: str, target_directory: str,
                 image_file_extension: str = ".png",
                 config: AugmentConfig = AugmentConfig(),
                 pair_source_directory: Optional[str] = None,
                 pair_target_directory: Optional[str] = None,
                 seed: int = 0):
        self.source_directory = source_directory
        self.target_directory = target_directory
        self.image_file_extension = image_file_extension
        self.config = config
        self.pair_source = pair_source_directory
        self.pair_target = pair_target_directory
        self.seed = seed
        self._results = []  # (filename, aug_index, raw_img, pair_img|None)

    def _listing(self, d):
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")
        return sorted(f for f in os.listdir(d) if f.lower().endswith(exts))

    def apply_augmentations(self, num_augmentations_per_image: int = 4):
        files = self._listing(self.source_directory)
        pair_files = self._listing(self.pair_source) if self.pair_source else None
        if pair_files is not None and len(pair_files) != len(files):
            raise ValueError("paired directories have different counts")
        for fi, fname in enumerate(files):
            raw = decode_image(os.path.join(self.source_directory, fname), None)
            if pair_files is not None:
                ref = decode_image(
                    os.path.join(self.pair_source, pair_files[fi]), None)
            else:
                ref = raw
            for ai in range(num_augmentations_per_image):
                rng = np.random.default_rng((self.seed, fi, ai))
                a, r = augment_pair_batch(raw[None], ref[None], rng,
                                          self.config)
                self._results.append(
                    (fname, ai, a[0], r[0] if pair_files is not None else None)
                )
        print(f"Finished applying augmentations. "
              f"{len(files)} images have augmented versions.")
        return self

    def save_augmented_images(self):
        from PIL import Image

        os.makedirs(self.target_directory, exist_ok=True)
        if self.pair_target:
            os.makedirs(self.pair_target, exist_ok=True)
        n = 0
        for fname, ai, a, r in self._results:
            stem, _ = os.path.splitext(fname)
            out = f"{stem}_aug{ai + 1}{self.image_file_extension}"
            Image.fromarray(a).save(os.path.join(self.target_directory, out))
            if r is not None and self.pair_target:
                Image.fromarray(r).save(os.path.join(self.pair_target, out))
            n += 1
        print(f"Saved {n} augmented images to {self.target_directory}")
        return n
