"""The port's exported serving forward (``tools/export_model.py``) on the
CPU, mirroring the JAX package's ``tests/test_export.py:13,42,72``:

- a symbolic-batch program of the small SpectralTransformer (the JAX
  test's config) and of a small AST equals the eager model (the same NHWC
  wrapper) within 1e-6 at batch 1 and 3, and so does a batch-2 program of
  the small NewModel-Wavelet and NewBigFRFNModel-Fourier (32x32, embed 8)
  at batch 2; its graph holds one custom-op node a fused call (8
  ``ln_mdta`` and 8 ``ln_gdfn``; 18 ``ln_leff`` and 10 ``window_attn``;
  9 and 10; 18 ``window_attn``, NewBigFRFNModel's token MLPs being
  FRFNs), and a program saved and loaded gives the same bits (the
  symbolic-batch export and the loading of a New* program take 6.5 s and
  7-14 s more a model on one core; ``chip_smoke.py`` 12(c) exports
  NewModel-Wavelet@256 with a symbolic batch, runs it at batch 8 and 3 and
  reloads it in a fresh process);
- the program matches the JAX package's StableHLO export of the same
  forward (``jax.export`` with a symbolic batch, for the New* models at
  batch 2, loaded by its ``load_exported``) on the same parameters within
  1e-4 x max(1, max|ref|), in f32, for SpectralTransformer and the two
  New* models (their JAX
  variables from the port's ``state_dict`` by the JAX package's
  ``convert_state_dict``; XLA's backend optimizations off, which would
  double the compile);
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

from underwater_image_restoration_tpu import models as jax_models
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    convert_state_dict,
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
                  {"ln_leff": 18, "window_attn": 10}),
          "NewModel-Wavelet": (dict(img_size=32, embed_dim=8,
                                    use_dwt="Wavelet"), 32,
                               {"ln_leff": 9, "window_attn": 10}),
          "NewBigFRFNModel-Fourier": (dict(img_size=32, embed_dim=8,
                                           use_dwt="Fourier"), 32,
                                      {"window_attn": 18})}
NEW_FAMILY = ("NewModel-Wavelet", "NewBigFRFNModel-Fourier")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


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
        model = init_model(arch.split("-")[0], device="cpu", seed=2, **kw)
        program = em.export_module(model, size,
                                   2 if arch in NEW_FAMILY else None)
        loaded = None
        if arch not in NEW_FAMILY:
            path = str(tmp_path_factory.mktemp("export") / f"{arch}.pt2")
            torch.export.save(program, path)
            loaded = em.load_exported(path)
        out[arch] = model, program, loaded
    return out


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_program_equals_eager_and_round_trips(exported, arch):
    model, program, loaded = exported[arch]
    _, size, nodes = MODELS[arch]
    assert dict(em.custom_op_counts(program)) == nodes
    eager = em.ServingForward(model)
    for batch in (2,) if arch in NEW_FAMILY else (1, 3):
        x = _images(batch, size, batch)
        with torch.no_grad():
            want = eager(x)
        got = program.module()(x)
        assert got.shape == (batch, size, size, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        if arch not in NEW_FAMILY:
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
    x = _images(3, 16, 7)
    xj = jnp.asarray(x.numpy())
    want = np.asarray(jax.jit(jax_load_exported(blob)).lower(xj).compile(
        compiler_options=FAST_COMPILE)(xj))
    np.testing.assert_allclose(
        program.module()(x).numpy(), want, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("key", NEW_FAMILY)
def test_new_family_program_matches_jax_export(exported, key):
    from jax import export as jax_export

    model, program, _ = exported[key]
    kw, size, _ = MODELS[key]
    name = key.split("-")[0]
    jm = getattr(jax_models, name)(**kw)
    variables = jax.tree.map(jnp.asarray, convert_state_dict(
        name, {k: v.numpy() for k, v in model.state_dict().items()}))

    def forward(x):
        return jm.apply(variables, x, deterministic=True).astype(jnp.float32)

    blob = jax_export.export(jax.jit(forward), platforms=["cpu"])(
        jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)).serialize()
    x = _images(2, size, 8)
    xj = jnp.asarray(x.numpy())
    want = np.asarray(jax.jit(jax_load_exported(blob)).lower(xj).compile(
        compiler_options=FAST_COMPILE)(xj))
    assert np.abs(want - x.numpy()).max() > 1e-3  # the network's branch
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
