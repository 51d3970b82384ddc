"""The port's Grad-CAM (``eval/gradcam.py``) against the JAX package's
(``eval/gradcam.py:43 grad_cam``) on the CPU in f32, at the small
SpectralTransformer of ``test_torch_train.py`` (channels 8/16/32/64, one
block a stage, one refinement block) on a 16x16 image: the CAM within
1e-5 and the activation within 1e-5 x max(1, max|ref|) at the notebook's
kind of target (``outputl``, at the input's size; the JAX function runs
eagerly, about 25 s on one core, and a target deeper in the network costs
it twice that, so it is called once); the resize of a smaller map against
``jax.image.resize``, and a block of the second encoder (8x8) giving an
input-sized map in [0, 1]; an unknown target raises ValueError, as in the
JAX test (``tests/test_eval.py:181``).  The JAX weights are the port's seeded init
carried by the JAX package's ``convert_spectral_transformer`` (no JAX init
compile).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.eval.gradcam import (
    grad_cam as jax_grad_cam,
)
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.eval.gradcam import (
    grad_cam,
    resize_cam,
)
from underwater_image_restoration_torch.models import init_model

CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    port = init_model("SpectralTransformer", device="cpu", seed=5, **CFG)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    raw, _ = synthetic_pair_batch(1, 16, seed=9)
    x = (raw.astype(np.float32) / 255.0 - 0.5) / 0.5
    return port, JaxSpectralTransformer(**CFG), {"params": unflatten(flat)}, x


def test_grad_cam_matches_jax(models):
    port, jm, variables, x = models
    want_cam, want_act = jax_grad_cam(jm, variables, jnp.asarray(x),
                                      target_path=("outputl",))
    cam, act = grad_cam(port, torch.from_numpy(x).permute(0, 3, 1, 2),
                        "outputl")
    assert cam.shape == (16, 16) and cam.dtype == np.float32
    assert cam.min() >= 0.0 and cam.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(cam, want_cam, atol=TOL, rtol=0)
    want_act = np.asarray(want_act)
    np.testing.assert_allclose(
        act.transpose(0, 2, 3, 1), want_act, rtol=0,
        atol=TOL * max(1.0, float(np.abs(want_act).max())))


@pytest.mark.parametrize("h", [4, 8])
def test_cam_resize_matches_jax_image_resize(h):
    m = np.random.default_rng(h).uniform(0, 1, (h, h)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (16, 16), "bilinear"))
    got = resize_cam(torch.from_numpy(m), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_grad_cam_at_a_smaller_block(models):
    port, _, _, x = models
    cam, act = grad_cam(port, torch.from_numpy(x).permute(0, 3, 1, 2),
                        "encoders.1.0")
    assert cam.shape == (16, 16) and act.shape == (1, 16, 8, 8)
    assert np.isfinite(cam).all()
    assert cam.min() >= 0.0 and cam.max() <= 1.0 + 1e-6


def test_unknown_target_raises(models):
    port, _, _, x = models
    with pytest.raises(ValueError, match="no_such_layer"):
        grad_cam(port, torch.from_numpy(x).permute(0, 3, 1, 2),
                 "no_such_layer")
