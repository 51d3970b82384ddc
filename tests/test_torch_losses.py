"""The port's losses (``underwater_image_restoration_torch/losses``) against
the JAX package's on the same data: NHWC arrays there, the same values
permuted to NCHW here.  Value and gradient of every ported name in f32
(value rtol 1e-5, gradient 1e-5 x max|ref|: f32 sums in another order), the
batch-scaling flags, psnr, and the unported names raising."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu import losses as jax_losses
from underwater_image_restoration_torch import losses


def _data(seed=0, shape=(2, 16, 12, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("name", losses.PORTED)
def test_loss_and_gradient_match_jax(name):
    p, t = _data()
    ref = jax_losses.LossFunction(name)
    want, want_g = jax.value_and_grad(lambda a: ref(a, jnp.asarray(t)))(
        jnp.asarray(p))
    port = losses.LossFunction(name)
    pt = _nchw(p).requires_grad_()
    got = port(pt, _nchw(t))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert (port.bc_divided, port.batch_linear) == (ref.bc_divided,
                                                    ref.batch_linear)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(pt.grad.permute(0, 2, 3, 1).numpy(), want_g,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_bf16_prediction_is_scored_in_f32():
    p, t = _data(1)
    port = losses.LossFunction("L1withColor")
    got = port(_nchw(p).bfloat16(), _nchw(t))
    want = port(_nchw(p).bfloat16().float(), _nchw(t))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_psnr_matches_jax():
    p, t = _data(2)
    want = float(jax_losses.psnr(jnp.asarray(t), jnp.asarray(p)))
    got = float(losses.psnr(_nchw(t), _nchw(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(set(losses.LOSS_NAMES)
                                        - set(losses.PORTED)))
def test_unported_names_raise(name):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        losses.LossFunction(name)


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="Unsupported loss"):
        losses.LossFunction("L3")
    assert losses.LOSS_NAMES == jax_losses.LOSS_NAMES
