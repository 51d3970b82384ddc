"""The port's Haar transforms (ops/wavelets.py) against the JAX package's
``ops/wavelets.py``, on the CPU, in f32.

- ``dwt2d`` and ``idwt2d`` forward;
- their backward passes, the reference's replayed ones (not the adjoints of
  the forwards), against ``jax.vjp`` of the JAX functions' custom VJPs:
  ``idwt2d`` on maps whose side is a multiple of 4 (the raw-reshape replay)
  and on one whose side is not (6: the true adjoint);
- a bf16 input comes back bf16, and C not a multiple of 4 raises.

Tolerance 1e-6 x max(1, max|ref|) on N(0, 1) inputs: both sides sum the
same f32 terms in another order; the IDWT backward's replay sums 16C
cotangents a value (|dx| up to about 25, where an f32 ulp is 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.ops import wavelets as jax_wavelets
from underwater_image_restoration_torch.ops import dwt2d, idwt2d

TOL = 1e-6


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))


@pytest.mark.parametrize("name, shape", [
    ("dwt2d", (2, 16, 16, 8)), ("dwt2d", (1, 8, 12, 4)),
    ("idwt2d", (2, 8, 8, 8)), ("idwt2d", (1, 4, 8, 12)),
    ("idwt2d", (2, 6, 6, 8))], ids=["dwt", "dwt-rect", "idwt", "idwt-rect",
                                   "idwt-side6-true-adjoint"])
def test_forward_and_replayed_backward_match_jax(name, shape):
    x, _ = _pair(shape, 0)
    port, ref = {"dwt2d": (dwt2d, jax_wavelets.dwt2d),
                 "idwt2d": (idwt2d, jax_wavelets.idwt2d)}[name]
    want, vjp = jax.vjp(ref, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    g = np.random.default_rng(1).standard_normal(got.shape).astype(
        np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    want_gx = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(gx.numpy(), want_gx, rtol=0,
                               atol=TOL * max(1.0, np.abs(want_gx).max()))


def test_backward_is_the_reference_not_the_adjoint():
    """The replayed DWT backward differs from the adjoint of its forward
    (the kept quirk): <dwt(x), g> != <x, dwt^T g>."""
    x, _ = _pair((1, 8, 8, 8), 2)
    xt = torch.from_numpy(x).requires_grad_()
    y = dwt2d(xt)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        y.shape).astype(np.float32))
    (gx,) = torch.autograd.grad(y, xt, g)
    lhs, rhs = float((y.detach() * g).sum()), float((x * gx.numpy()).sum())
    assert abs(lhs - rhs) > 1e-3 * abs(lhs)


def test_dtype_and_channel_check():
    x = torch.randn(1, 8, 8, 8, dtype=torch.bfloat16)
    assert dwt2d(x).dtype == torch.bfloat16
    assert idwt2d(x).shape == (1, 16, 16, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        dwt2d(torch.zeros(1, 8, 8, 6))
