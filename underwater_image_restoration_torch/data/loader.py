"""Deterministic, checkpointable, prefetching paired loader, the port's own
copy of the JAX package's ``data/loader.py`` (``Batch``, ``PairedLoader``,
``get_dataloaders``), replacing the reference's ``get_dataloaders``
(DataLoader.py:11-32: torch DataLoader, 4 workers, shuffle train / ordered
test):

- decode runs in a thread pool (PIL releases the GIL in decode/resize) and
  the next batches are prefetched while the device steps;
- batches are uint8 NHWC on the host; they go to the device as uint8 and are
  normalized there (``train.trainer.normalize_u8``);
- iteration order is a pure function of ``(seed, epoch)``, and
  ``state_dict()/load_state_dict()`` let a resumed run replay the exact
  remaining order;
- a short final batch is padded to full size by repeating its last pair,
  with a ``valid`` mask (the train step trains on the padding, as the JAX
  step does; the eval step masks it); a decode error reaches the consumer;
- ``rows`` (data parallelism, ``core.meshes.DataParallel.rows``) keeps
  those rows of every (padded, augmented) batch: a rank's share of the
  batch order one device would take.  Without augmentation only those rows
  are decoded.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .augment import AugmentConfig, augment_pair_batch
from .uieb import UIEBDataset


@dataclasses.dataclass
class Batch:
    raw: np.ndarray    # (B,H,W,3) uint8
    ref: np.ndarray    # (B,H,W,3) uint8
    valid: np.ndarray  # (B,) bool — False for padding rows of a short batch
    index: int = 0     # true batch index within the epoch (survives a
                       # mid-epoch resume, where iteration starts at
                       # _start_batch and enumerate() would restart at 0)

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


class PairedLoader:
    """Iterable over epochs of Batch.  One pass = one epoch (reference
    semantics: ``for batch in train_loader`` inside the epoch loop,
    ModelTrainer.py:71)."""

    def __init__(
        self,
        dataset: UIEBDataset,
        batch_size: int,
        shuffle: bool,
        seed: int = 1,
        num_workers: int = 4,
        augment: Optional[AugmentConfig] = None,
        pad_final: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.augment = augment
        self.pad_final = pad_final
        self.prefetch = prefetch
        self.epoch = 0
        self._start_batch = 0  # resume offset within the current epoch
        self.rows: Optional[np.ndarray] = None  # a rank's rows of a batch

    # -- checkpointable iteration state ------------------------------------
    def state_dict(self):
        return {"epoch": self.epoch, "batch": self._start_batch, "seed": self.seed}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])
        self._start_batch = int(state["batch"])
        self.seed = int(state["seed"])

    # -----------------------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self.seed, epoch)).permutation(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.pad_final:
            return (n + self.batch_size - 1) // self.batch_size
        return max(1, n // self.batch_size) if n >= self.batch_size else 0

    def _make_batch(self, idxs: np.ndarray, epoch: int, bi: int, pool) -> Batch:
        valid = np.ones(self.batch_size, bool)
        valid[len(idxs):] = False  # a short final batch repeats its last pair
        idxs = np.concatenate([idxs, np.repeat(idxs[-1:],
                                               self.batch_size - len(idxs))])
        augment = self.augment is not None and self.augment.enabled
        rows = self.rows
        if rows is not None and not augment:  # decode the rank's rows alone
            idxs, valid, rows = idxs[rows], valid[rows], None
        pairs = list(pool.map(self.dataset.__getitem__, idxs.tolist()))
        raw = np.stack([p[0] for p in pairs])
        ref = np.stack([p[1] for p in pairs])
        if augment:
            # counter-based rng: deterministic per (seed, epoch, batch index)
            arng = np.random.default_rng((self.seed, epoch, bi))
            raw, ref = augment_pair_batch(raw, ref, arng, self.augment)
        if rows is not None:
            raw, ref, valid = raw[rows], ref[rows], valid[rows]
        return Batch(raw=raw, ref=ref, valid=valid, index=bi)

    def __iter__(self) -> Iterator[Batch]:
        epoch = self.epoch
        order = self._epoch_order(epoch)
        nb = len(self)
        start = self._start_batch
        self._start_batch = 0

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for bi in range(start, nb):
                    if stop.is_set():
                        return
                    lo = bi * self.batch_size
                    idxs = order[lo: lo + self.batch_size]
                    if len(idxs) == 0:
                        break
                    if len(idxs) < self.batch_size and not self.pad_final:
                        break
                    try:
                        q.put((bi, self._make_batch(idxs, epoch, bi, pool)))
                    except Exception as e:  # surface decode errors to consumer
                        q.put((bi, e))
                        return
            q.put((None, None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                bi, item = q.get()
                if bi is None:
                    break
                if isinstance(item, Exception):
                    raise item
                self._start_batch = bi + 1  # checkpoint points at next batch
                yield item
        finally:
            stop.set()
            # drain so the producer's put() never blocks forever
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
        self.epoch = epoch + 1
        self._start_batch = 0


def get_dataloaders(
    raw_dir: str,
    ref_dir: str,
    test_raw_dir: str,
    test_ref_dir: str,
    batch_size: int = 16,
    num_workers: int = 4,
    image_size: int = 1024,
    test_batch_size: Optional[int] = None,
    seed: int = 1,
    augment: Optional[AugmentConfig] = None,
    cache_dir: Optional[str] = None,
):
    """API parity with reference DataLoader.py:11: (train, test) loaders,
    the train one shuffled by ``(seed, epoch)`` and augmented with
    ``augment``, the test one in listing order.

    cache_dir: when set, decode+resize runs once and later epochs stream
    uint8 slices from a disk memmap (data/cache.py)."""
    from .cache import maybe_cached

    train = PairedLoader(
        maybe_cached(UIEBDataset(raw_dir, ref_dir, image_size), cache_dir),
        batch_size=batch_size, shuffle=True, seed=seed,
        num_workers=num_workers, augment=augment,
    )
    test = PairedLoader(
        maybe_cached(UIEBDataset(test_raw_dir, test_ref_dir, image_size),
                     cache_dir),
        batch_size=test_batch_size or batch_size, shuffle=False, seed=seed,
        num_workers=num_workers, augment=None,
    )
    return train, test
