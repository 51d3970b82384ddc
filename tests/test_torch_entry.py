"""The port's serving entry points, and its separation from the JAX package.

- ``batched_apply``/``run_batched`` on a uint8 batch equal the JAX package's
  ``_batched_apply``/``_run_batched`` with the same weights (f32, CPU);
- the ``infer`` subcommand writes one PNG a input image, for
  SpectralTransformer and for AST;
- without CUDA and without ``device="cpu"`` the entry points raise;
- every module of the port (the training modules, losses and backward
  kernels' sources, the training run, data pipeline, observability and
  CLI included) imports with ``jax`` and the JAX package blocked, and no
  file of the port names either.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.eval import evaluate as jax_eval
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_ast,
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_torch import _device
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.eval import evaluate
from underwater_image_restoration_torch.models import init_model

CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)
SIZE = 16
PORT = pathlib.Path(__file__).resolve().parent.parent / \
    "underwater_image_restoration_torch"


@pytest.fixture(scope="module")
def models():
    port = init_model("SpectralTransformer", device="cpu", seed=3, **CFG)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return port, flat


def test_batched_apply_matches_jax(models):
    port, flat = models
    u8, _ = synthetic_pair_batch(3, SIZE, seed=1)
    jax_model = JaxSpectralTransformer(**CFG)
    params = {"params": jax.tree.map(jnp.asarray, unflatten(flat))}
    apply_j, bs = jax_eval._batched_apply(jax_model, params, 2)
    apply_t, _ = evaluate.batched_apply(port, 2)
    want = dict(jax_eval._run_batched(iter(u8), 3, apply_j, bs))
    got = dict(evaluate.run_batched(iter(u8), 3, apply_t, bs))
    assert sorted(got) == [0, 1, 2]
    for i in range(3):
        assert got[i].shape == (SIZE, SIZE, 3) and got[i].dtype == np.float32
        np.testing.assert_allclose(
            got[i], want[i],
            atol=1e-4 * max(1.0, float(np.abs(want[i]).max())))


def test_infer_subcommand_writes_images(tmp_path):
    """The subcommand builds the full-width model, as the JAX one does."""
    from PIL import Image

    port = init_model("SpectralTransformer", device="cpu", seed=4)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    weights = tmp_path / "params.npz"
    np.savez(weights, **flat)
    src = tmp_path / "in"
    src.mkdir()
    for i, img in enumerate(synthetic_pair_batch(3, 24, seed=2)[0]):
        Image.fromarray(img).save(src / f"{i}.png")
    out = tmp_path / "out"
    n = evaluate.main(["infer", "--weights", str(weights), "-a",
                       "SpectralTransformer", "--use-dwt", "Fourier",
                       "--input", str(src), "--out", str(out), "--size",
                       str(SIZE), "--batch", "2", "--device", "cpu",
                       "--compute-dtype", "fp32"])
    assert n == 3
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png"]


def test_infer_subcommand_serves_ast(tmp_path):
    """``infer -a AST`` builds the full-width AST for ``--size`` and loads
    the JAX package's flat parameters."""
    from PIL import Image

    port = init_model("AST", device="cpu", seed=5, img_size=32)
    weights = tmp_path / "ast.npz"
    np.savez(weights, **convert_ast(
        {k: v.numpy() for k, v in port.state_dict().items()}))
    src = tmp_path / "in"
    src.mkdir()
    for i, img in enumerate(synthetic_pair_batch(2, 40, seed=3)[0]):
        Image.fromarray(img).save(src / f"{i}.png")
    out = tmp_path / "out"
    n = evaluate.main(["infer", "--weights", str(weights), "-a", "AST",
                       "--input", str(src), "--out", str(out), "--size",
                       "32", "--batch", "2", "--device", "cpu",
                       "--compute-dtype", "fp32"])
    assert n == 2
    assert sorted(os.listdir(out)) == ["0.png", "1.png"]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.CudaUnavailableError, match="device='cpu'"):
        init_model("SpectralTransformer", **CFG)
    with pytest.raises(_device.CudaUnavailableError, match="device='cpu'"):
        init_model("AST", img_size=32, embed_dim=8, win_size=4)
    with pytest.raises(_device.CudaUnavailableError, match="device='cpu'"):
        init_model("NewModel", img_size=32, embed_dim=8, use_dwt="Wavelet")
    with pytest.raises(_device.CudaUnavailableError):
        evaluate.load_model("unused.npz", "SpectralTransformer")
    with pytest.raises(_device.CudaUnavailableError):
        evaluate.load_model("unused.npz", "AST", img_size=32)
    assert _device.resolve_device("cpu").type == "cpu"


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['underwater_image_restoration_tpu'] = None\n"
        "import underwater_image_restoration_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print(' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PORT.parent))
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 20
    pkg = "underwater_image_restoration_torch."
    for mod in ("losses", "losses.primitives", "train", "train.optim",
                "train.trainer", "tools.profile_train", "ops.fused_gdfn",
                "ops.fused_mdta", "ops.fused_leff", "ops.window_attention",
                "ops.windows", "ops.droppath", "models.ast",
                "models.blocks", "models.new_model", "ops.wavelets",
                "core.config", "cli.args", "cli.main", "data.uieb",
                "data.augment", "data.cache", "data.loader", "data.manager",
                "losses.msssim", "train.metrics", "train.checkpoint",
                "obs.loggers", "obs.sinks", "obs.profiler",
                "obs.visualiser", "losses.ffl", "losses.perceptual",
                "tools.convert_vgg16", "eval.uiqm", "eval.metrics",
                "data.custom", "data.offline_augment", "core.meshes",
                "tools.export_model", "eval.gradcam"):
        assert pkg + mod in names, mod


def test_port_files_name_no_jax():
    files = [p for p in PORT.rglob("*") if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 31
    assert {"ln_gdfn_bwd.cu", "ln_mdta_bwd.cu", "grad.cuh", "ln_leff.cu",
            "ln_leff_bwd.cu", "window_attn.cu", "ast.py",
            "window_attention.py", "new_model.py", "wavelets.py",
            "window_attn_bwd.cu", "wattn.cuh"} <= {
        p.name for p in files}
    for p in files:
        text = p.read_text()
        assert "underwater_image_restoration_tpu" not in text, p
        assert "import jax" not in text, p


def test_kernel_cache_key_covers_shared_headers(tmp_path, monkeypatch):
    """An edit to any source in csrc/, a shared header included, names
    another cached library, so a stale build is never loaded."""
    from underwater_image_restoration_torch.ops import _kernels

    for src in _kernels.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    before = {n: _kernels._target(n) for n in _kernels.kernel_names()}
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _kernels._target(name) != path
        assert _kernels._target(name).name.startswith(name + "-")
