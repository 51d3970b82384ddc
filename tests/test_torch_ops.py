"""The port's plain ops against the JAX package's, in f32 on the CPU.

Inputs are made with numpy from a seed and given to both packages; the JAX
side is NHWC, the port NCHW.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu import ops as jops
from underwater_image_restoration_tpu.ops import spectral as jspec
from underwater_image_restoration_torch import ops as tops

TOL = 1e-5


def _nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture
def img(rng):
    return rng.standard_normal((2, 8, 12, 6)).astype(np.float32)


def test_layer_norm_channels(img, rng):
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = jops.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(img))
    got = tops.layer_norm_channels(_nchw(img), torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("name", ["gelu", "leaky_relu"])
def test_elementwise(img, name):
    want = getattr(jops, name)(jnp.asarray(img))
    got = getattr(tops, name)(torch.from_numpy(img))
    _close(got.numpy(), want)


@pytest.mark.parametrize("zero_row", [False, True])
def test_l2_normalize(img, zero_row):
    x = img.copy()
    if zero_row:
        x[0, 1] = 0.0
    want = jops.l2_normalize(jnp.asarray(x), axis=-1)
    t = torch.from_numpy(x).requires_grad_()
    got = tops.l2_normalize(t, dim=-1)
    _close(got.detach().numpy(), want)
    got.sum().backward()
    assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("fn", ["pixel_shuffle", "pixel_unshuffle"])
def test_resample(img, fn):
    x = np.concatenate([img] * 2, axis=-1)  # 12 channels: shuffle needs r*r
    want = getattr(jops, fn)(jnp.asarray(x), 2)
    got = getattr(tops, fn)(_nchw(x), 2)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_fft_pair(img):
    want = jspec.fft2(jnp.asarray(img))
    got = tops.fft2(_nchw(img))
    _close(np.transpose(got.numpy(), (0, 2, 3, 1)), want)
    back = tops.ifft2(got).real
    _close(_nhwc(back), img)


def test_safe_abs_angle_zero_bins():
    """Exactly-zero bins: |0| = 0, angle(+0+0j) = 0, angle(-0.0+0j) = pi
    (arctan2 signed-zero edge), and zero gradients there."""
    re = np.array([0.0, -0.0, 1.0, -2.0, 0.0], np.float32)
    im = np.array([0.0, 0.0, 1.0, 0.5, -3.0], np.float32)
    f_np = re + 1j * im
    want_abs = jspec.safe_abs(jnp.asarray(f_np, jnp.complex64))
    want_ang = jspec.safe_angle(jax.lax.complex(jnp.asarray(re),
                                                jnp.asarray(im)))
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    f = torch.complex(tre, tim)
    np.testing.assert_array_equal(tops.safe_abs(f).detach().numpy(),
                                  np.asarray(want_abs))
    ang = tops.safe_angle(f)
    np.testing.assert_array_equal(ang.detach().numpy(), np.asarray(want_ang))
    assert ang[1].item() == pytest.approx(np.pi)
    (tops.safe_abs(f).sum() + ang.sum()).backward()
    for g in (tre.grad, tim.grad):
        assert torch.isfinite(g).all()
        assert g[0].item() == 0.0 and g[1].item() == 0.0


def test_zero_stuff2x(img):
    want = jspec.zero_stuff2x(jnp.asarray(img))
    got = tops.zero_stuff2x(_nchw(img))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_spectral_tile_upsample(img, rng):
    pha = rng.uniform(-np.pi, np.pi, img.shape).astype(np.float32)
    mag = np.abs(img)
    want = jspec.spectral_tile_upsample(jnp.asarray(mag), jnp.asarray(pha))
    got = tops.spectral_tile_upsample(_nchw(mag), _nchw(pha))
    _close(_nhwc(got), want)


def test_channel_attention_core(rng):
    q, k, v = (rng.standard_normal((2, 2, 4, 30)).astype(np.float32)
               for _ in range(3))
    temp = rng.uniform(0.5, 2.0, (1, 2, 1, 1)).astype(np.float32)
    want_out, want_attn = jops.channel_attention_core(
        *(jnp.asarray(a) for a in (q, k, v, temp)))
    got_out, got_attn = tops.channel_attention_core(
        *(torch.from_numpy(a) for a in (q, k, v, temp)))
    _close(got_out.numpy(), want_out)
    _close(got_attn.numpy(), want_attn)
