"""Decoded-image cache, the port's own copy of the JAX package's
``data/cache.py``: decode+resize once, then epochs read a uint8 memmap.

The reference re-decodes and re-resizes every image every epoch (reference
DataLoader.py:13-15); here the decoded uint8 tensors are written once to a
disk-backed memmap and later epochs stream slices of it; normalization
happens on the device.

Cache layout under ``cache_dir``:
    <tag>.raw.u8      (N, S, S, 3) uint8 memmap
    <tag>.ref.u8      (N, S, S, 3) uint8 memmap
    <tag>.manifest.json   {size, paths+mtimes}  — invalidation key

``tag`` hashes the pair listing (paths, mtimes, sizes) and resolution, so a
changed file or another ``--image-size`` names another cache.  Building is
atomic (tmp + rename), so a killed first run never leaves a half-valid
cache.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from .uieb import UIEBDataset


def _listing_key(ds: UIEBDataset) -> dict:
    def ent(paths):
        return [[p, os.path.getmtime(p), os.path.getsize(p)] for p in paths]

    return {"size": ds.image_size, "raw": ent(ds.raw_paths),
            "ref": ent(ds.ref_paths)}


class CachedUIEBDataset:
    """UIEBDataset wrapper serving decoded pairs from a uint8 memmap."""

    def __init__(self, dataset: UIEBDataset, cache_dir: str):
        if dataset.image_size is None:
            raise ValueError("decoded cache needs a fixed image_size")
        self.dataset = dataset
        self.image_size = dataset.image_size
        os.makedirs(cache_dir, exist_ok=True)
        key = _listing_key(dataset)
        blob = json.dumps(key, sort_keys=True).encode()
        tag = hashlib.sha256(blob).hexdigest()[:16]
        self._raw_path = os.path.join(cache_dir, f"{tag}.raw.u8")
        self._ref_path = os.path.join(cache_dir, f"{tag}.ref.u8")
        manifest = os.path.join(cache_dir, f"{tag}.manifest.json")
        n, s = len(dataset), dataset.image_size
        shape = (n, s, s, 3)
        if not os.path.exists(manifest):
            self._build(shape, manifest, blob)
        self._raw = np.memmap(self._raw_path, dtype=np.uint8, mode="r",
                              shape=shape)
        self._ref = np.memmap(self._ref_path, dtype=np.uint8, mode="r",
                              shape=shape)

    def _build(self, shape, manifest: str, key_blob: bytes):
        raw_tmp, ref_tmp = self._raw_path + ".tmp", self._ref_path + ".tmp"
        raw = np.memmap(raw_tmp, dtype=np.uint8, mode="w+", shape=shape)
        ref = np.memmap(ref_tmp, dtype=np.uint8, mode="w+", shape=shape)
        for i in range(shape[0]):
            r, g = self.dataset[i]
            raw[i], ref[i] = r, g
        raw.flush()
        ref.flush()
        del raw, ref
        os.replace(raw_tmp, self._raw_path)
        os.replace(ref_tmp, self._ref_path)
        tmp = manifest + ".tmp"
        with open(tmp, "wb") as f:
            f.write(key_blob)
        os.replace(tmp, manifest)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        # Items own their memory: a memmap slice is a view of the read-only
        # mmap, which an in-place consumer would fail on or alias.
        return self._raw[idx].copy(), self._ref[idx].copy()


def maybe_cached(dataset: UIEBDataset,
                 cache_dir: Optional[str]) -> object:
    return CachedUIEBDataset(dataset, cache_dir) if cache_dir else dataset
