"""The port's eval-notebook datasets (``data/custom.py``) and offline
augmentor (``data/offline_augment.py``) against the JAX package's: numpy and
PIL on both sides, so every item and every written PNG is bit-equal.

- ``U45Dataset``: the sorted listing filtered by extension (a text file is
  skipped), each resized item and its index;
- ``CustomImageDataset``: two directory pairs matched by filename (names
  without a reference are skipped), the input, the reference at the input
  size and at the larger size;
- ``DataAugmentor``: two augmentations of each image for one seed, unpaired
  and paired, the written ``<stem>_aug<i><ext>`` files; another seed writes
  other images.
"""
import os

import numpy as np
import pytest
from PIL import Image

from underwater_image_restoration_tpu.data import custom as jax_custom
from underwater_image_restoration_tpu.data import (
    offline_augment as jax_offline,
)
from underwater_image_restoration_torch.data import (
    CustomImageDataset,
    DataAugmentor,
    U45Dataset,
    synthetic_pair_batch,
)


def _write(d, images, names):
    d.mkdir(parents=True, exist_ok=True)
    for img, name in zip(images, names):
        Image.fromarray(img).save(d / name)
    return str(d)


def _same_items(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b


def test_u45_dataset_is_the_jax_one(tmp_path):
    raw, _ = synthetic_pair_batch(3, 30, seed=0)
    d = _write(tmp_path / "u45", raw, ["c.png", "a.jpg", "b.bmp"])
    (tmp_path / "u45" / "notes.txt").write_text("not an image")
    got, want = U45Dataset(d, 24), jax_custom.U45Dataset(d, 24)
    assert got.paths == want.paths and len(got) == 3
    assert got[0][0].shape == (24, 24, 3) and got[2][1] == 2
    _same_items(got, want)


def test_custom_image_dataset_is_the_jax_one(tmp_path):
    raw, ref = synthetic_pair_batch(5, 30, seed=1)
    ins = [_write(tmp_path / "in1", raw[:3], ["x.png", "y.png", "z.png"]),
           _write(tmp_path / "in2", raw[3:], ["p.png", "q.png"])]
    refs = [_write(tmp_path / "ref1", ref[:2], ["y.png", "x.png"]),
            _write(tmp_path / "ref2", ref[3:], ["q.png", "r.png"])]
    got = CustomImageDataset(ins, refs, 16, 40)
    want = jax_custom.CustomImageDataset(ins, refs, 16, 40)
    assert got.input_paths == want.input_paths and len(got) == 3
    assert [os.path.basename(p) for p in got.reference_paths] == [
        "x.png", "y.png", "q.png"]
    x, ref_l, ref_h, idx = got[1]
    assert x.shape == ref_l.shape == (16, 16, 3) and ref_h.shape == (40, 40,
                                                                     3)
    _same_items(got, want)


def _written(d):
    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("paired", [False, True])
def test_data_augmentor_writes_the_jax_images(tmp_path, paired):
    raw, ref = synthetic_pair_batch(3, 24, seed=2)
    src = _write(tmp_path / "src", raw, ["a.png", "b.png", "c.png"])
    pair = (_write(tmp_path / "pair", ref, ["a.png", "b.png", "c.png"])
            if paired else None)
    out = {}
    for side, cls in (("port", DataAugmentor),
                      ("jax", jax_offline.DataAugmentor)):
        tgt, ptgt = tmp_path / side / "a", tmp_path / side / "b"
        aug = cls(src, str(tgt), pair_source_directory=pair,
                  pair_target_directory=str(ptgt) if paired else None,
                  seed=3)
        assert aug.apply_augmentations(2).save_augmented_images() == 6
        out[side] = (_written(tgt), _written(ptgt) if paired else {})
    names = sorted(f"{s}_aug{i}.png" for s in "abc" for i in (1, 2))
    assert sorted(out["port"][0]) == names
    assert sorted(out["port"][1]) == (names if paired else [])
    for got, want in zip(out["port"], out["jax"]):
        assert got.keys() == want.keys()
        for f in want:
            assert np.array_equal(got[f], want[f]), f
    other = tmp_path / "other"
    DataAugmentor(src, str(other), seed=4).apply_augmentations(
        2).save_augmented_images()
    assert any(not np.array_equal(a, b) for a, b in zip(
        _written(other).values(), out["port"][0].values()))
