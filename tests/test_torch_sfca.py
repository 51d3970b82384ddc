"""The port's dormant SpectralTransformer modules (``inv_mag``, ``AGSSF``,
``SFCA``; ``models/spectral_transformer.py``) against the JAX package's
(``models/spectral_transformer.py:291-358``) on the CPU in f32: outputs and
gradients (of the input and of every parameter, for a random cotangent)
within 1e-5 x max(1, max|ref|).  The JAX modules' parameters reach the port
through ``tools.convert.params_from_jax`` (the mapping of their trees), so
the converter is checked too.  ``inv_mag`` is also held at an input whose
spectrum has exactly-zero bins, where ``safe_angle`` gives a zero (not NaN)
gradient, and AGSSF's kernel-size rule against the JAX module's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.models.spectral_transformer import (
    AGSSF as JaxAGSSF,
    SFCA as JaxSFCA,
    inv_mag as jax_inv_mag,
)
from underwater_image_restoration_torch.models.spectral_transformer import (
    AGSSF,
    SFCA,
)
from underwater_image_restoration_torch.ops import inv_mag
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    params_from_jax,
)

TOL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0, err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape).astype(np.float32),
            g.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "zero_bins"])
def test_inv_mag_and_its_gradient_match_jax(case):
    x, ct = _inputs((2, 8, 8, 4), 0)
    if case == "zero_bins":
        # constant images: every bin but DC is exactly zero
        x = np.broadcast_to(x[:, :1, :1], x.shape).copy()
    y, vjp = jax.vjp(jax_inv_mag, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(ct))
    xt = _nchw(x).requires_grad_()
    out = inv_mag(xt)
    out.backward(_nchw(ct))
    assert torch.isfinite(xt.grad).all()
    _close(_nhwc(out), y, "inv_mag")
    _close(_nhwc(xt.grad), gx, "d inv_mag / dx")


def _port(module, jax_params):
    sd = params_from_jax(flatten(jax.tree.map(np.asarray, jax_params)))
    module.load_state_dict(sd, strict=True)
    return module


def _check_module(jax_module, port_module, x, ct):
    variables = jax_module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = variables["params"]
    if "conv" in params and params["conv"].ndim == 3:
        # the init's taps are small; make the gate's argument O(1)
        params = {**params, "conv": params["conv"] * 4}
    if "agssf" in params:
        params = {**params, "agssf": {"conv": params["agssf"]["conv"] * 4}}

    def f(p, xx):
        return jnp.sum(jax_module.apply({"params": p}, xx) * ct)

    y = jax_module.apply({"params": params}, jnp.asarray(x))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    m = _port(port_module, params)
    xt = _nchw(x).requires_grad_()
    out = m(xt)
    (out * _nchw(ct)).sum().backward()
    _close(_nhwc(out), y, "forward")
    _close(_nhwc(xt.grad), gx, "dx")
    want = params_from_jax(flatten(jax.tree.map(np.asarray, gp)))
    got = dict(m.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        _close(got[name].grad.numpy(), g.numpy(), name)


def test_agssf_matches_jax():
    x, ct = _inputs((2, 8, 8, 16), 1)
    _check_module(JaxAGSSF(16), AGSSF(16), x, ct)


def test_sfca_matches_jax():
    x, ct = _inputs((2, 8, 8, 8), 2)
    _check_module(JaxSFCA(8), SFCA(8), x, ct)


@pytest.mark.parametrize("c", [4, 8, 16, 32, 64, 128, 256])
def test_agssf_kernel_size_rule(c):
    k = JaxAGSSF(c)._kernel_size()
    assert AGSSF.kernel_size(c) == k
    assert tuple(AGSSF(c).conv.weight.shape) == (1, 1, k)
