"""The port's losses (``underwater_image_restoration_torch/losses``) against
the JAX package's on the same data: NHWC arrays there, the same values
permuted to NCHW here.

- value and gradient of all 20 names in f32: value rtol 1e-5, gradient
  1e-5 x max|ref| (f32 sums in another order; FFTs and convolutions of
  another library).  The names built on MS-SSIM run at 176x176 (its guard
  needs sides > 160), and ``perceptual`` with them, the rest at 16x12; the
  perceptual family runs on both
  sides' placeholder VGG16 trunk (bit-equal weights).  Its gradient is
  discontinuous (the sign of each L1 term, the ReLUs), and f32 roundoff
  flips some of those points in either framework, which moves single
  pixels' gradient by a few percent of max|g|, so no two f32
  implementations meet 1e-5 x max|ref| there.  The perceptual family's
  gradient is held in relative L2 norm, 1e-2 (the card against the CPU
  read 5.5e-5 to 2.6e-3 in ``chip_smoke.py`` phase 11(d)), its value at
  rtol 1e-5 as the others;
- fflMix's five components, the batch-scaling flags, psnr;
- the perceptual family refused without a weights file, MS-SSIM's size
  guard, FFL's options against ``losses.ffl.focal_frequency_loss``;
- the VGG16 trunk: the placeholder bit-equal to the JAX one, an ``.npz``
  and a torchvision features state dict loading the same trunk, the
  features at 32x32 without the resize (rtol 1e-5 of max|ref|), and the
  bilinear resize against ``ops.resample.resize_bilinear`` (atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu import losses as jax_losses
from underwater_image_restoration_tpu.losses import ffl as jax_ffl
from underwater_image_restoration_tpu.losses import perceptual as jax_perc
from underwater_image_restoration_tpu.ops.resample import resize_bilinear
from underwater_image_restoration_torch import losses
from underwater_image_restoration_torch.losses import ffl, perceptual
from underwater_image_restoration_torch.tools.convert_vgg16 import (
    convert_state_dict,
)

# the names that call ms_ssim, which needs sides > 160, and perceptual,
# which shares the mixtures' trunk shapes at that size
LARGE_NAMES = ("ms_ssim", "mix", "fflMixTV", "bigMix", "fflMix",
               "ssimFFLCharbonnier", "perceptual")


@pytest.fixture(autouse=True, scope="module")
def _quiet_placeholder():
    """Both packages warn once about the placeholder trunk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_perc, "_warned", True)
        mp.setattr(perceptual, "_warned", True)
        yield


def _data(seed=0, shape=(2, 16, 12, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous()


def _first(res):
    return res[0] if isinstance(res, tuple) else res


@pytest.mark.parametrize("name", losses.LOSS_NAMES)
def test_loss_and_gradient_match_jax(name):
    shape = (1, 176, 176, 3) if name in LARGE_NAMES else (2, 16, 12, 3)
    p, t = _data(shape=shape)
    ref = jax_losses.LossFunction(name, allow_placeholder_vgg=True)
    want, want_g = jax.value_and_grad(lambda a, b: _first(ref(a, b)))(
        jnp.asarray(p), jnp.asarray(t))
    port = losses.LossFunction(name, allow_placeholder_vgg=True)
    pt = _nchw(p).requires_grad_()
    got = _first(port(pt, _nchw(t)))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert (port.bc_divided, port.batch_linear, port.returns_components) == (
        ref.bc_divided, ref.batch_linear, ref.returns_components)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g, got_g = np.asarray(want_g), pt.grad.permute(0, 2, 3, 1).numpy()
    if name in losses.PERCEPTUAL_FAMILY:
        assert np.linalg.norm(got_g - want_g) <= 1e-2 * np.linalg.norm(want_g)
    else:
        np.testing.assert_allclose(got_g, want_g,
                                   atol=1e-5 * float(np.abs(want_g).max()))


def test_ffl_mix_components_match_jax():
    p, t = _data(3, (1, 176, 176, 3))
    ref = jax_losses.LossFunction("fflMix", allow_placeholder_vgg=True)
    # through value_and_grad, whose eager ops the gradient test compiled
    (_, want), _ = jax.value_and_grad(lambda a, b: (ref(a, b)[0], ref(a, b)),
                                      has_aux=True)(jnp.asarray(p),
                                                    jnp.asarray(t))
    with torch.no_grad():
        got = losses.LossFunction("fflMix", allow_placeholder_vgg=True)(
            _nchw(p), _nchw(t))
    assert len(got) == len(want) == 6 and len(losses.COMPONENTS) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    np.savez(path, **jax_perc._placeholder_weights())
    return str(path)


@pytest.mark.parametrize("name", sorted(losses.PERCEPTUAL_FAMILY))
def test_perceptual_family_needs_weights(name, tmp_path, vgg_npz):
    with pytest.raises(FileNotFoundError, match="VGG16"):
        losses.LossFunction(name)
    with pytest.raises(FileNotFoundError, match="VGG16"):
        losses.LossFunction(name, vgg_weights=str(tmp_path / "none.npz"))
    assert losses.LossFunction(name, vgg_weights=vgg_npz).loss_name == name


def test_ms_ssim_size_guard():
    p, t = _data(4, (1, 160, 176, 3))
    with pytest.raises(ValueError, match="sides > 160"):
        losses.ms_ssim(_nchw(p), _nchw(t))
    with pytest.raises(ValueError, match="sides > 160"):
        jax_losses.ms_ssim(jnp.asarray(p), jnp.asarray(t))


@pytest.mark.parametrize("kw", [
    dict(patch_factor=2), dict(ave_spectrum=True), dict(log_matrix=True),
    dict(batch_matrix=True), dict(alpha=2.0),
    dict(patch_factor=2, ave_spectrum=True, log_matrix=True,
         batch_matrix=True, alpha=2.0, loss_weight=0.5)])
def test_ffl_options_match_jax(kw):
    p, t = _data(5, (2, 16, 12, 3))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda a, b: jax_ffl.focal_frequency_loss(a, b, **kw)))(
        jnp.asarray(p), jnp.asarray(t))
    pt = _nchw(p).requires_grad_()
    got = ffl.focal_frequency_loss(pt, _nchw(t), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(pt.grad.permute(0, 2, 3, 1).numpy(), want_g,
                               atol=1e-5 * float(np.abs(want_g).max()))
    with pytest.raises(ValueError, match="patch_factor"):
        ffl.focal_frequency_loss(pt, _nchw(t), patch_factor=5)


def test_placeholder_trunk_is_the_jax_one():
    want = jax_perc._placeholder_weights()
    got = perceptual._placeholder_weights()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_npz_and_torchvision_state_dict_load_one_trunk(tmp_path):
    """The JAX package's .npz layout and a torchvision ``features`` state
    dict (OIHW, indices 0-21) of the same weights give one trunk."""
    rng = np.random.default_rng(6)
    state = {}
    for idx, (_, oc, ic) in zip(
            (0, 2, 5, 7, 10, 12, 14, 17, 19, 21),
            [c for c in perceptual._VGG16_CFG if c != "M"]):
        state[f"{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((oc, ic, 3, 3)).astype(np.float32))
        state[f"{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(oc).astype(np.float32))
    npz, pt = tmp_path / "vgg.npz", tmp_path / "features.pt"
    np.savez(npz, **convert_state_dict(state))
    torch.save(state, pt)
    a = perceptual.load_vgg16_weights(str(npz))
    b = perceptual.load_vgg16_weights(str(pt))
    assert sorted(a) == sorted(b) and len(a) == 20
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(a["conv0.kernel"],
                          state["0.weight"].numpy().transpose(2, 3, 1, 0))
    jax_layers = jax_perc.load_vgg16_weights(str(npz))
    for name, k, bias in jax_layers:
        if name != "M":
            assert np.array_equal(a[f"{name}.kernel"], k), name
            assert np.array_equal(a[f"{name}.bias"], bias), name


def test_trunk_features_match_jax_without_resize():
    p, t = _data(7, (2, 32, 32, 3))
    want = jax_perc.vgg_perceptual_loss(jnp.asarray(p), jnp.asarray(t),
                                        resize=False)
    got = perceptual.vgg_perceptual_loss(_nchw(p), _nchw(t), resize=False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    layers = jax_perc.load_vgg16_weights("")
    want_f = jax_perc._vgg_features(jnp.asarray(p), layers)
    got_f = perceptual._vgg_features(_nchw(p), perceptual._trunk(
        "", torch.device("cpu")))
    assert len(got_f) == len(want_f) == 4
    for g, w in zip(got_f, want_f):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("shape", [(2, 176, 176, 3), (1, 256, 200, 3),
                                   (1, 16, 12, 3)])
def test_resize_matches_resize_bilinear(shape):
    x, _ = _data(8, shape)
    want = np.asarray(resize_bilinear(jnp.asarray(x), 224, 224))
    got = perceptual.resize_bilinear(_nchw(x), 224, 224)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


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


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="Unsupported loss"):
        losses.LossFunction("L3")
    assert losses.LOSS_NAMES == jax_losses.LOSS_NAMES
