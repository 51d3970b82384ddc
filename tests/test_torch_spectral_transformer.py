"""The port's SpectralTransformer against the JAX package's, in f32 on the
CPU (where the JAX model runs its unfused NHWC path), at a small config:
channels (8, 16, 32, 64), one block a stage, one refinement block, a
1x32x32x3 input.  Weights are the JAX model's, carried by
``tools.convert.params_from_jax``; the tolerance (1e-4 x max(1, max|ref|))
covers FFT roundoff between torch.fft and jnp.fft.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_state_dict,
)
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools.convert import (
    load_reference_state_dict,
    params_from_jax,
)

CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_model():
    x = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    m = JaxSpectralTransformer(**CFG)
    variables = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    y = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(x)))
    return x, params, y


def _port_model(params):
    model = init_model("SpectralTransformer", device="cpu", **CFG)
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return model


def test_forward_matches_jax(jax_model):
    x, params, want = jax_model
    model = _port_model(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(
        got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_state_dict_round_trip(jax_model):
    """The JAX converter maps the port's state_dict back onto the JAX tree:
    the port's names and layouts are the reference's."""
    _, params, _ = jax_model
    sd = {k: v.numpy() for k, v in _port_model(params).state_dict().items()}
    back = _flat(convert_state_dict("SpectralTransformer", sd)["params"])
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_reference_state_dict_loads_strict(jax_model):
    """A reference checkpoint carries parameters its forward never uses;
    they are dropped and the rest loads strict."""
    _, params, _ = jax_model
    sd = dict(_port_model(params).state_dict())
    sd["ups_4.reduce.weight"] = torch.zeros(1)
    sd["output1.weight"] = torch.zeros(1)
    sd["encoders.0.0.attn.q1X1_2.weight"] = torch.zeros(1)
    model = init_model("SpectralTransformer", device="cpu", seed=1, **CFG)
    load_reference_state_dict(model, {"model_state_dict": sd})
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_other_architectures_are_not_ported_yet():
    """Every architecture of the registry is ported now: each builds on the
    CPU (small configurations), and an unknown name raises."""
    from underwater_image_restoration_torch.models import get_names

    assert sorted(get_names()) == sorted([
        "SpectralTransformer", "AST", "NewModel", "NewBigModel",
        "NewBigFRFNModel"])
    for name in get_names():
        kw = CFG if name == "SpectralTransformer" else dict(img_size=32,
                                                            embed_dim=8)
        model = init_model(name, device="cpu", use_dwt="Wavelet", **kw)
        assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(KeyError, match="Unknown model"):
        init_model("NoSuchModel", device="cpu")
