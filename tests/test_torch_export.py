"""The port's exported serving forward (``tools/export_model.py``) on the
CPU, mirroring the JAX package's ``tests/test_export.py:13,42,72``:

- a symbolic-batch program of the small SpectralTransformer (the JAX
  test's config) and of a small AST equals the eager model (the same
  NHWC wrapper) within 1e-6 at batch 1 and 3, its graph holds one custom-op
  node a fused call (8 ``ln_mdta`` and 8 ``ln_gdfn``; 18 ``ln_leff`` and
  10 ``window_attn``), and a program saved and loaded gives the same bits;
- the program matches the JAX package's StableHLO export of the same
  forward (``jax.export`` with a symbolic batch, loaded by its
  ``load_exported``) on the same parameters within 1e-4 x max(1, max|ref|),
  in f32;
- the CLI exports a checkpoint directory of the port's trainer (``--weights
  <dir> --use-cpu``), and the loaded program equals the model;
- ``export_model`` (the default-config model) gives a program whose output
  has the input's shape and is finite.

On the CPU the custom ops run the plain versions; on the card the same
nodes run the kernels (``chip_smoke.py`` phase 12).
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
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_tpu.tools.export_model import (
    load_exported as jax_load_exported,
)
from underwater_image_restoration_torch import models
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools import export_model as em
from underwater_image_restoration_torch.train import CheckpointManager

SPECTRAL = dict(num_blocks=(1, 1, 1, 1), channels=(4, 8, 16, 32),
                num_heads=(1, 2, 4, 8), num_refinement=1)
MODELS = {"SpectralTransformer": (SPECTRAL, 16,
                                  {"ln_mdta": 8, "ln_gdfn": 8}),
          "AST": (dict(img_size=32, embed_dim=8), 32,
                  {"ln_leff": 18, "window_attn": 10})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(batch, size, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = {}
    for arch, (kw, size, _) in MODELS.items():
        model = init_model(arch, device="cpu", seed=2, **kw)
        program = em.export_module(model, size)
        path = str(tmp_path_factory.mktemp("export") / f"{arch}.pt2")
        torch.export.save(program, path)
        out[arch] = model, program, em.load_exported(path)
    return out


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_program_equals_eager_and_round_trips(exported, arch):
    model, program, loaded = exported[arch]
    _, size, nodes = MODELS[arch]
    assert dict(em.custom_op_counts(program)) == nodes
    eager = em.ServingForward(model)
    for batch in (1, 3):
        x = _images(batch, size, batch)
        with torch.no_grad():
            want = eager(x)
        got = program.module()(x)
        assert got.shape == (batch, size, size, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(loaded(x), got)


def test_program_matches_jax_export(exported):
    from jax import export as jax_export

    model, program, _ = exported["SpectralTransformer"]
    jm = JaxSpectralTransformer(**SPECTRAL)
    variables = {"params": jax.tree.map(jnp.asarray, unflatten(
        convert_spectral_transformer({k: v.numpy() for k, v in
                                      model.state_dict().items()})))}

    def forward(x):
        return jm.apply(variables, x, deterministic=True).astype(jnp.float32)

    (b,) = jax_export.symbolic_shape("b")
    blob = jax_export.export(jax.jit(forward), platforms=["cpu"])(
        jax.ShapeDtypeStruct((b, 16, 16, 3), jnp.float32)).serialize()
    fn = jax_load_exported(blob)
    x = _images(3, 16, 7)
    want = np.asarray(fn(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(
        program.module()(x).numpy(), want, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_export_cli_from_checkpoint_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(models, "init_model",
                        lambda arch, **k: init_model(arch, **k, **SPECTRAL))
    model = models.init_model("SpectralTransformer", device="cpu", seed=4)
    CheckpointManager(str(tmp_path / "ck")).save(
        0, params=model.state_dict(), opt_state={}, epoch=0, val_loss=1.0)
    out = tmp_path / "m.pt2"
    em.main(["-a", "SpectralTransformer", "--weights", str(tmp_path / "ck"),
             "--size", "16", "--batch", "2", "--compute-dtype", "float32",
             "--use-cpu", "--out", str(out)])
    fn = em.load_exported(str(out))
    x = _images(2, 16, 3)
    with torch.no_grad():
        want = em.ServingForward(model)(x)
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


def test_export_model_entry_point():
    state = init_model("SpectralTransformer", device="cpu",
                       seed=1).state_dict()
    program = em.export_model("SpectralTransformer", state, size=16,
                              batch=2, compute_dtype=torch.float32,
                              device="cpu")
    out = program.module()(torch.zeros(2, 16, 16, 3))
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    assert dict(em.custom_op_counts(program)) == {"ln_mdta": 24,
                                                  "ln_gdfn": 24}
