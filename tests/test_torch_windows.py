"""The port's window helpers (ops/windows.py) against the JAX package's
``ops/windows.py`` and ``parallel/cp_ops.py:67 roll2d`` (no mesh), on the
CPU.  Partition, reverse and roll move values without arithmetic, and the
mask and index builders are integer-valued: all are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.ops import windows as jax_windows
from underwater_image_restoration_tpu.parallel import cp_ops
from underwater_image_restoration_torch.ops import windows


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape, ws", [((2, 8, 8, 3), 4), ((1, 16, 8, 5), 8),
                                       ((3, 4, 4, 2), 2)])
def test_partition_and_reverse_match_jax(shape, ws):
    x = _x(shape)
    got = windows.window_partition(torch.from_numpy(x), ws)
    want = np.asarray(jax_windows.window_partition(jnp.asarray(x), ws))
    np.testing.assert_array_equal(got.numpy(), want)
    back = windows.window_reverse(got, ws, shape[1], shape[2])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jax_windows.window_reverse(jnp.asarray(want), ws,
                                              shape[1], shape[2])))


@pytest.mark.parametrize("h, w, ws, ss", [(8, 8, 4, 2), (16, 16, 8, 4),
                                          (16, 8, 4, 2), (32, 32, 8, 4)])
def test_shift_mask_matches_jax(h, w, ws, ss):
    got = windows.shift_window_mask(h, w, ws, ss)
    want = jax_windows.shift_window_mask(h, w, ws, ss)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    dev = windows.shift_mask(h, w, ws, ss, "cpu")
    np.testing.assert_array_equal(dev.numpy(), want)
    assert windows.shift_mask(h, w, ws, ss, "cpu") is dev  # cached


@pytest.mark.parametrize("wh, ww", [(2, 2), (4, 4), (8, 8), (3, 5)])
def test_relative_position_index_matches_jax(wh, ww):
    got = windows.relative_position_index(wh, ww)
    want = jax_windows.relative_position_index(wh, ww)
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == (2 * wh - 1) * (2 * ww - 1) - 1


@pytest.mark.parametrize("shift", [2, -2, 4, -4])
def test_roll_matches_jax_roll2d(shift):
    x = _x((2, 8, 8, 3), seed=1)
    got = torch.roll(torch.from_numpy(x), (shift, shift), (1, 2))
    want = np.asarray(cp_ops.roll2d(jnp.asarray(x), shift, shift, None))
    np.testing.assert_array_equal(got.numpy(), want)
