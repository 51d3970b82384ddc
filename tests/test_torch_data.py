"""The port's data pipeline (``data/uieb.py``, ``augment.py``, ``cache.py``,
``loader.py``, ``manager.py``) against the JAX package's, on the CPU: for
the same directories and seed both yield the same uint8 batches, ``valid``
masks and batch indices (exact equality: both are numpy over the same
decoded bytes), through shuffling, the padded final batch, ``color_aug``
augmentation, a mid-epoch resume, the decoded cache and its invalidation,
and a decode error reaching the consumer.
"""
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from underwater_image_restoration_tpu.data import augment as jax_augment
from underwater_image_restoration_tpu.data import cache as jax_cache
from underwater_image_restoration_tpu.data import loader as jax_loader
from underwater_image_restoration_tpu.data import manager as jax_manager
from underwater_image_restoration_tpu.data import uieb as jax_uieb
from underwater_image_restoration_torch.data import (
    AugmentConfig,
    DataManager,
    PairedLoader,
    UIEBDataset,
    augment_pair_batch,
    get_dataloaders,
    synthetic_pair_batch,
)
from underwater_image_restoration_torch.data.cache import CachedUIEBDataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 16


def _write_pairs(root, n, seed, size=20):
    raw, ref = synthetic_pair_batch(n, size, seed=seed)
    dirs = []
    for sub, arr in (("a", raw), ("b", ref)):
        d = root / sub
        d.mkdir(parents=True)
        for i, img in enumerate(arr):
            Image.fromarray(img).save(d / f"{i:03d}.png")
        dirs.append(str(d))
    return dirs


@pytest.fixture
def dirs(tmp_path):
    """5 train and 3 test pairs at 20x20 (resized to SIZE on decode)."""
    return (_write_pairs(tmp_path / "train", 5, 0)
            + _write_pairs(tmp_path / "test", 3, 1))


def _epochs(loader, n):
    out = []
    for _ in range(n):
        out.append([(b.raw, b.ref, b.valid, b.index) for b in loader])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for (gr, gf, gv, gi), (wr, wf, wv, wi) in zip(g, w):
            assert gr.dtype == np.uint8 and gr.shape == wr.shape
            np.testing.assert_array_equal(gr, wr)
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gv, wv)
            assert gi == wi


def test_dataset_matches_jax(dirs):
    raw_dir, ref_dir = dirs[:2]
    got, want = UIEBDataset(raw_dir, ref_dir, SIZE), jax_uieb.UIEBDataset(
        raw_dir, ref_dir, SIZE)
    assert len(got) == len(want) == 5
    assert got.raw_paths == want.raw_paths
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            assert a.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(a, b)
    os.remove(os.path.join(ref_dir, "004.png"))
    for cls in (UIEBDataset, jax_uieb.UIEBDataset):
        with pytest.raises(ValueError, match="unpaired"):
            cls(raw_dir, ref_dir, SIZE)


@pytest.mark.parametrize("shuffle,batch,augment", [
    (True, 2, False), (False, 2, False), (True, 3, True), (True, 5, True)])
def test_loader_batches_match_jax(dirs, shuffle, batch, augment):
    """Two epochs; batch 2 and 3 pad the final batch of 5 pairs."""
    ds = UIEBDataset(dirs[0], dirs[1], SIZE)
    aug = AugmentConfig() if augment else None
    jaug = jax_augment.AugmentConfig() if augment else None
    got = PairedLoader(ds, batch, shuffle, seed=7, num_workers=2,
                       augment=aug)
    want = jax_loader.PairedLoader(ds, batch, shuffle, seed=7,
                                   num_workers=2, augment=jaug)
    assert len(got) == len(want) == -(-5 // batch)
    g, w = _epochs(got, 2), _epochs(want, 2)
    _assert_same(g, w)
    if batch < 5:
        assert not g[0][-1][2].all()  # the padded final batch is masked
    if shuffle:
        assert not np.array_equal(g[0][0][0], g[1][0][0])
    assert got.state_dict() == want.state_dict() == {
        "epoch": 2, "batch": 0, "seed": 7}


def test_get_dataloaders_with_color_aug_match_jax(dirs):
    kw = dict(batch_size=2, test_batch_size=2, num_workers=2,
              image_size=SIZE, seed=3)
    train, test = get_dataloaders(*dirs, augment=AugmentConfig(), **kw)
    jtrain, jtest = jax_loader.get_dataloaders(
        *dirs, augment=jax_augment.AugmentConfig(), **kw)
    _assert_same(_epochs(train, 2), _epochs(jtrain, 2))
    _assert_same(_epochs(test, 1), _epochs(jtest, 1))
    assert test.augment is None and not test.shuffle


def test_augment_matches_jax():
    raw, ref = synthetic_pair_batch(6, SIZE, seed=4)
    for seed in range(3):
        got = augment_pair_batch(raw, ref, np.random.default_rng(seed))
        want = jax_augment.augment_pair_batch(
            raw, ref, np.random.default_rng(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    off = AugmentConfig(enabled=False)
    assert augment_pair_batch(raw, ref, np.random.default_rng(0), off)[0] \
        is raw


def test_mid_epoch_resume_matches_jax(dirs):
    """The state after two batches of epoch 1, loaded into a new loader,
    replays the rest of the epoch and the next as the unbroken run does."""
    ds = UIEBDataset(dirs[0], dirs[1], SIZE)
    runs = []
    for cls, aug in ((PairedLoader, AugmentConfig()),
                     (jax_loader.PairedLoader, jax_augment.AugmentConfig())):
        whole = cls(ds, 2, True, seed=5, num_workers=1, augment=aug)
        _epochs(whole, 1)
        unbroken = _epochs(whole, 2)
        first = cls(ds, 2, True, seed=5, num_workers=1, augment=aug)
        _epochs(first, 1)
        it = iter(first)
        next(it), next(it)
        state = first.state_dict()
        it.close()
        assert state == {"epoch": 1, "batch": 2, "seed": 5}
        resumed = cls(ds, 2, True, seed=0, num_workers=1, augment=aug)
        resumed.load_state_dict(state)
        rest = _epochs(resumed, 2)
        assert [b[3] for b in rest[0]] == [2]
        _assert_same([rest[0], rest[1]], [unbroken[0][2:], unbroken[1]])
        runs.append(rest)
    _assert_same(*runs)


def test_decoded_cache_and_invalidation(dirs, tmp_path):
    raw_dir, ref_dir = dirs[:2]
    plain = UIEBDataset(raw_dir, ref_dir, SIZE)
    port_dir, jax_dir = tmp_path / "c_port", tmp_path / "c_jax"
    cached = CachedUIEBDataset(plain, str(port_dir))
    jax_cached = jax_cache.CachedUIEBDataset(
        jax_uieb.UIEBDataset(raw_dir, ref_dir, SIZE), str(jax_dir))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(port_dir)) == 3
    for i in range(len(plain)):
        for a, b, c in zip(cached[i], plain[i], jax_cached[i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            assert a.flags.owndata and a.flags.writeable
    # an edited image names another cache, built from the new bytes
    new = np.full((20, 20, 3), 200, np.uint8)
    Image.fromarray(new).save(os.path.join(raw_dir, "001.png"))
    os.utime(os.path.join(raw_dir, "001.png"), (1e9, 1e9))
    fresh = CachedUIEBDataset(UIEBDataset(raw_dir, ref_dir, SIZE),
                              str(port_dir))
    assert len(os.listdir(port_dir)) == 6
    np.testing.assert_array_equal(fresh[1][0], np.full((SIZE, SIZE, 3), 200))
    with pytest.raises(ValueError, match="fixed image_size"):
        CachedUIEBDataset(UIEBDataset(raw_dir, ref_dir, None), str(port_dir))


def test_decode_errors_reach_the_consumer(dirs):
    with open(os.path.join(dirs[0], "002.png"), "wb") as f:
        f.write(b"not an image")
    ds = UIEBDataset(dirs[0], dirs[1], SIZE)
    errors = []
    for cls in (PairedLoader, jax_loader.PairedLoader):
        loader = cls(ds, 2, False, num_workers=1)
        seen = []
        with pytest.raises(Exception) as exc:
            for b in loader:
                seen.append(b.index)
        assert seen == [0]
        errors.append(type(exc.value))
    assert errors[0] is errors[1]


def test_data_manager_matches_jax(dirs, tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setitem(sys.modules, "kagglehub", None)
    for cls in (DataManager, jax_manager.DataManager):
        dm = cls()
        assert not dm.setDownloadedLocations(str(empty), dirs[1])
        with pytest.raises(RuntimeError, match="kagglehub is not installed"):
            dm.download()
        assert dm.setDownloadedLocations(dirs[0], dirs[1])
        assert dm.download() == (dirs[0], dirs[1])
        assert dm.load_image(os.path.join(dirs[0], "000.png"),
                             SIZE).shape == (SIZE, SIZE, 3)
