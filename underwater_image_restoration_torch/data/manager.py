"""Dataset orchestration, the port's own copy of the JAX package's
``data/manager.py`` ``DataManager`` (reference
``src/DataManipulation/DataManager.py``): record existing UIEB locations,
download them with kagglehub (gated: it raises with guidance when kagglehub
is missing; there is no network here), resize offline (optional: the
loader resizes online).  Augmentation is online (``augment.py``).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

from .uieb import decode_image

KAGGLE_RAW = "larjeck/uieb-dataset-raw"
KAGGLE_REF = "larjeck/uieb-dataset-reference"


class DataManager:
    def __init__(self, data_root: str = "../data"):
        self.data_root = data_root
        self.raw_dir: Optional[str] = None
        self.ref_dir: Optional[str] = None
        self.use_existing = False

    def setDownloadedLocations(self, raw_dir: str, ref_dir: str):
        """Parity with DataManager.setDownloadedLocations (DataManager.py:28-36):
        if both dirs already have files, mark them usable and skip download."""
        if os.path.isdir(raw_dir) and os.listdir(raw_dir) and \
           os.path.isdir(ref_dir) and os.listdir(ref_dir):
            self.raw_dir, self.ref_dir = raw_dir, ref_dir
            self.use_existing = True
        return self.use_existing

    def download(self, dest: Optional[str] = None):
        """Kaggle download via kagglehub (reference DownloaderKaggle.py:11-32).
        Gated: raises a clear error if kagglehub isn't installed/authed."""
        if self.use_existing:
            return self.raw_dir, self.ref_dir
        try:
            import kagglehub  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "kagglehub is not installed; place UIEB data manually and call "
                "setDownloadedLocations(raw_dir, ref_dir)"
            ) from e
        dest = dest or os.path.join(self.data_root, "kaggle")
        os.makedirs(dest, exist_ok=True)
        out = []
        for name, sub in ((KAGGLE_RAW, "raw"), (KAGGLE_REF, "reference")):
            path = kagglehub.dataset_download(name)
            target = os.path.join(dest, sub)
            if not os.path.isdir(target):
                shutil.copytree(path, target)
            out.append(target)
        self.raw_dir, self.ref_dir = out
        return self.raw_dir, self.ref_dir

    @staticmethod
    def resize_images(src_dir: str, dst_dir: str, size: int = 1024):
        """Offline bicubic resize (reference ImageManipulator.py:9-54 with the
        DataManager.py:73-74 call-name mismatch fixed)."""
        from PIL import Image

        os.makedirs(dst_dir, exist_ok=True)
        for f in sorted(os.listdir(src_dir)):
            p = os.path.join(src_dir, f)
            try:
                with Image.open(p) as im:
                    im.convert("RGB").resize((size, size), Image.BICUBIC).save(
                        os.path.join(dst_dir, f)
                    )
            except OSError:
                continue

    @staticmethod
    def load_image(path: str, size: Optional[int] = None):
        return decode_image(path, size)
