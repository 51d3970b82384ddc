"""The port's validation metrics (``losses/msssim.py`` ``ssim``,
``train/metrics.py``) and eval step (``train/trainer.py make_eval_step``)
against the JAX package's, on the CPU in f32, tolerance 1e-5 (relative):

- ``ssim`` and ``ssim_metric`` on NCHW against the JAX ``ssim`` on NHWC
  (11-tap gaussian, VALID padding), and the per-sample PSNR (with the
  [0, 1] clamp of [-1, 1] tensors) and SSIM;
- ``make_eval_step`` on a padded batch (its last row repeats the one
  before and is masked) through the same 1x1-convolution model on both
  sides, for L1 (divided by B*C), charbonnier (batch-linear) and
  AdaptiveLuminanceCharbonnier (batch-coupled: the full-batch loss times
  the valid count); for the first two the masked sums equal the sums of the
  unpadded batch.
"""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.losses import (
    LossFunction as JaxLossFunction,
)
from underwater_image_restoration_tpu.losses import msssim as jax_msssim
from underwater_image_restoration_tpu.train import metrics as jax_metrics
from underwater_image_restoration_tpu.train import trainer as jax_trainer
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.losses import msssim
from underwater_image_restoration_torch.train import make_eval_step
from underwater_image_restoration_torch.train import metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _pair(seed, shape=(3, 24, 24, 3)):
    g = np.random.default_rng(seed)
    t = g.uniform(-1, 1, shape).astype(np.float32)
    p = np.clip(t + g.normal(0, 0.3, shape), -1.2, 1.2).astype(np.float32)
    return t, p


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("data_range", [1.0, 2.0])
def test_ssim_matches_jax(data_range):
    t, p = _pair(0)
    got = msssim.ssim(_nchw(t), _nchw(p), data_range=data_range)
    want = jax_msssim.ssim(t, p, data_range=data_range)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(
        float(metrics.ssim_metric(_nchw(t), _nchw(p))),
        float(jax_metrics.ssim_metric(t, p)), rtol=TOL)


def test_per_sample_metrics_match_jax():
    t, p = _pair(1)
    np.testing.assert_allclose(
        metrics.per_sample_psnr(_nchw(t), _nchw(p)).numpy(),
        np.asarray(jax_metrics.per_sample_psnr(t, p)), rtol=TOL)
    np.testing.assert_allclose(
        metrics.per_sample_ssim(_nchw(t), _nchw(p)).numpy(),
        np.asarray(jax_metrics.per_sample_ssim(t, p)), rtol=TOL)


class _JaxConv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(3, (1, 1))(x)


class _TorchConv(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 1)
        self.conv.weight.data = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        self.conv.bias.data = torch.from_numpy(b)

    def forward(self, x, use_kernels=True):
        return self.conv(x)


@pytest.mark.parametrize("loss", ["L1", "charbonnier",
                                  "AdaptiveLuminanceCharbonnier"])
def test_eval_step_matches_jax_on_a_padded_batch(loss):
    g = np.random.default_rng(2)
    w = (np.eye(3)[None, None] * 0.8 + g.normal(0, 0.1, (1, 1, 3, 3))
         ).astype(np.float32)
    b = g.normal(0, 0.05, 3).astype(np.float32)
    raw, ref = synthetic_pair_batch(2, 24, seed=3)
    raw = np.concatenate([raw, raw[-1:]])  # the loader's padding
    ref = np.concatenate([ref, ref[-1:]])
    valid = np.array([True, True, False])
    params = {"params": {"Conv_0": {"kernel": jnp.asarray(w),
                                    "bias": jnp.asarray(b)}}}
    want = jax_trainer.make_eval_step(_JaxConv(), JaxLossFunction(loss))(
        params, raw, ref, valid)
    step = make_eval_step(_TorchConv(w, b), LossFunction(loss))
    got = step(raw, ref, valid)
    for k in ("loss_sum", "psnr_sum", "ssim_sum", "n"):
        assert got[k].shape == () and got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=TOL, err_msg=k)
    if loss != "AdaptiveLuminanceCharbonnier":
        unpadded = step(raw[:2], ref[:2], valid[:2])
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(unpadded[k]),
                                       rtol=TOL, err_msg=k)
