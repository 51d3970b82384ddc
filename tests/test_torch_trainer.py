"""The port's training run (``train/trainer.py ModelTrainer``) against the
JAX package's ``ModelTrainer`` on the CPU, in f32, at the small
SpectralTransformer of ``test_torch_train.py`` (channels 8/16/32/64, one
block a stage, one refinement block), 32x32, 5 train and 3 test pairs,
batch 2 (both loaders pad a short final batch), ``mesh_data=1``, L1 (the
CLI's default, and ``evaluate``'s loss, so both share one compiled JAX eval
step), JSONL metrics only.

Both trainers build their model through a substitute ``init_model``
(monkeypatched into both trainer modules; nothing in the JAX package is
edited) holding the same weights: the port's seeded init, carried to the
JAX tree by the JAX package's ``convert_spectral_transformer`` (the JAX
init would cost 15 s of compile on one core).  The JAX steps are built and
compiled once a configuration for the module (``_CompiledOnce``: the
compiled executable, its arguments placed on the shardings it was compiled
for) and reused by the resumed run and by ``evaluate`` (the trainer's eval
step over its one-device mesh computes what ``evaluate``'s unsharded one
does).  They are compiled with XLA's backend (LLVM) optimizations off,
which halves the compile on one core (the train step's 39 s to 21 s) and
leaves the program's operations as they are (the losses move by about
1e-6 relative, inside TOL).

- SGD (lr 1e-2, momentum 0.9): every batch's loss and grad_norm, each
  epoch's validation loss, PSNR and SSIM (from the runs' ``metrics.jsonl``)
  and every parameter after each epoch, within 1e-4 x max(1, max|ref|)
  (SGD because Adam's first steps are lr * sign(g); see
  ``test_torch_train.py``); the best/latest steps on disk (the orbax step
  numbers against the port's step directories);
- Adam (lr 3e-4): one epoch's losses within 1e-3 relative (Adam's first
  steps are lr * sign(g), where roundoff flips a few elements);
- resume: a 3-epoch port run equals a 2-epoch run plus a 1-epoch resume bit
  for bit (losses, parameters, optimizer state, loader state), and the
  resumed losses match JAX's resumed run within the same tolerance;
- ``ModelTrainer.evaluate`` on the best checkpoint matches the JAX one, and
  returns the PSNR and SSIM the trainer logged for that epoch;
- ``histograms`` against ``jnp.histogram`` on the same tensors, a constant
  one included: edges to 1e-6 relative, counts within 1 each, sums equal
  (the trainers' watch histograms are held against JAX in
  ``test_torch_watch.py``);
- the checkpoint manager's best/latest rules and the refusals of settings
  the port does not run.

The port runs watch every 2nd step (``watch_freq=2``); the JAX runs
without (its watch step over the SpectralTransformer's 220 tensors costs
30 s of compile), which also shows that the watch leaves the training
alone.
"""
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from underwater_image_restoration_tpu.core.config import Config as JaxConfig
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_tpu.train import trainer as jax_trainer
from underwater_image_restoration_torch.core.config import Config
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    params_from_jax,
)
from underwater_image_restoration_torch.train import (
    CheckpointManager,
    restore_params,
)
from underwater_image_restoration_torch.train import trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)
# the functions the runs wrap, taken before any test patches them
REAL = {"jax_train": jax_trainer.make_train_step,
        "jax_eval": jax_trainer.make_eval_step,
        "port_train": trainer.make_train_step}
TOL = 1e-4
SETTINGS = dict(image_size=32, train_batch_size=2, test_batch_size=2,
                compute_dtype="float32", mesh_data=1, use_wandb=False,
                lossf="L1", workers=1, print_freq=100)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _write_pairs(root):
    for split, n, seed in (("train", 5, 0), ("test", 3, 1)):
        raw, ref = synthetic_pair_batch(n, 32, seed=seed)
        for sub, arr in (("a", raw), ("b", ref)):
            d = root / split / sub
            d.mkdir(parents=True)
            for i, img in enumerate(arr):
                Image.fromarray(img).save(d / f"{i:03d}.png")
    return [str(root / s / x) for s in ("train", "test") for x in "ab"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _series(run_dir, key):
    return [r[key] for r in _records(run_dir) if key in r]


def _steps(run_dir, which):
    d = pathlib.Path(run_dir) / which
    return sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())


class _FixedInit:
    """A JAX model whose ``init`` returns the given (host) weights."""

    def __init__(self, module, params):
        self.module, self._params = module, params

    def init(self, rng, x):
        return jax.tree.map(jnp.asarray, self._params)

    def apply(self, *a, **k):
        return self.module.apply(*a, **k)


# per-compile XLA options of the JAX steps: the same HLO, generated without
# LLVM's optimization passes
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


class _CompiledOnce:
    """A jitted JAX function compiled once, with FAST_COMPILE, on its first
    call's arguments; later calls place their arguments on the shardings it
    was compiled for (one compile whatever the callers' placements)."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, None

    def __call__(self, *args):
        if self.compiled is None:
            self.compiled = self.jitted.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        else:
            args = jax.device_put(args, self.compiled.input_shardings[0])
        return self.compiled(*args)


class _Runs:
    """Both trainers over one data tree, their steps' metrics recorded."""

    def __init__(self, mp, root, jax_model, port_model):
        self.root, self.dirs = root, _write_pairs(root / "data")
        self.key, self.built = None, {}
        self.metrics = {"jax": [], "port": []}

        def jax_train(model, lossfn, tx, **kw):
            k = ("train", self.key)
            if k not in self.built:
                self.built[k] = _CompiledOnce(
                    REAL["jax_train"](model, lossfn, tx, **kw))
            return self._recorded("jax", self.built[k])

        def jax_eval(model, lossfn, mesh=None):
            k = ("eval", lossfn.loss_name)
            if k not in self.built:
                self.built[k] = _CompiledOnce(
                    REAL["jax_eval"](model, lossfn, mesh=mesh))
            return self.built[k]

        mp.setattr(jax_trainer, "init_model", lambda *a, **k: jax_model())
        mp.setattr(jax_trainer, "make_train_step", jax_train)
        mp.setattr(jax_trainer, "make_eval_step", jax_eval)
        mp.setattr(trainer, "init_model",
                   lambda arch, **k: port_model(k["device"]))
        mp.setattr(trainer, "make_train_step", lambda *a, **k: self._recorded(
            "port", REAL["port_train"](*a, **k)))

    def _recorded(self, side, fn):
        def step(*args):
            out = fn(*args)
            self.metrics[side].append(out[-1] if side == "jax" else out)
            return out
        return step

    def run(self, side, name, **kw):
        """Train; returns (run dir, [(loss, grad_norm)], [params by epoch]:
        flat JAX paths, or the port's names).
        Runs of one ``optim`` share the JAX train step."""
        self.key = kw.get("optim")
        self.metrics[side] = []
        params = []
        ckpt = str(self.root / side / name)
        if side == "jax":
            cfg = JaxConfig(checkpoint_dir=ckpt, **SETTINGS).replace(**kw)
            tr = jax_trainer.ModelTrainer(*self.dirs)
            tr.train(cfg, on_epoch_end=lambda e, st, v: params.append(
                flatten(jax.tree.map(np.asarray, st.params["params"]))))
        else:
            cfg = Config(checkpoint_dir=ckpt, use_cpu=True,
                         **SETTINGS).replace(**kw)
            tr = trainer.ModelTrainer(*self.dirs)
            tr.train(cfg, on_epoch_end=lambda e, m, v: params.append(
                {n: p.detach().clone() for n, p in m.named_parameters()}))
        run_dir = kw.get("resume") or os.path.join(ckpt,
                                                   os.listdir(ckpt)[0])
        metrics = [(float(m["loss"]), float(m["grad_norm"]))
                   for m in self.metrics[side]]
        return run_dir, metrics, params

    def evaluate(self, side, run_dir):
        if side == "jax":
            cfg = JaxConfig(**SETTINGS)
            return jax_trainer.ModelTrainer(*self.dirs).evaluate(
                cfg, os.path.join(run_dir, "best"))
        cfg = Config(use_cpu=True, **SETTINGS)
        return trainer.ModelTrainer(*self.dirs).evaluate(
            cfg, os.path.join(run_dir, "best"))


@pytest.fixture(scope="module")
def spectral(tmp_path_factory):
    port = init_model("SpectralTransformer", device="cpu", seed=3, **CFG)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    host = unflatten(flat)
    weights = params_from_jax(flat)

    def port_model(device):
        m = init_model("SpectralTransformer", device=device, seed=0, **CFG)
        m.load_state_dict(weights, strict=True)
        return m

    with pytest.MonkeyPatch.context() as mp:
        runs = _Runs(mp, tmp_path_factory.mktemp("spectral"),
                     lambda: _FixedInit(JaxSpectralTransformer(**CFG),
                                        {"params": host}), port_model)
        sgd = dict(optim="sgd", lr=1e-2)
        out = {"jax2": runs.run("jax", "sgd", max_epoch=2, watch_freq=0,
                                **sgd)}
        out["jax_resumed"] = runs.run("jax", "sgd", max_epoch=3,
                                      watch_freq=0,
                                      resume=out["jax2"][0], **sgd)
        out["port3"] = runs.run("port", "sgd3", max_epoch=3, watch_freq=2,
                                **sgd)
        out["port2"] = runs.run("port", "sgd2", max_epoch=2, watch_freq=2,
                                **sgd)
        out["port_resumed"] = runs.run("port", "sgd2", max_epoch=3,
                                       watch_freq=2,
                                       resume=out["port2"][0], **sgd)
        out["eval"] = {side: runs.evaluate(side, out[run][0]) for side, run
                       in (("jax", "jax2"), ("port", "port2"))}
        adam = dict(optim="adam", lr=3e-4, max_epoch=1, watch_freq=0)
        out["adam"] = {side: runs.run(side, "adam", **adam)
                       for side in ("jax", "port")}
        yield out


def test_sgd_run_matches_jax(spectral):
    jax_dir, want, want_params = spectral["jax2"]
    port_dir, got, got_params = spectral["port3"]
    assert len(want) == 6 and len(got) == 9  # 3 batches an epoch
    _close(np.array(got[:6]), np.array(want), "loss, grad_norm a batch")
    # the JAX run's directory holds its resumed epoch's records too
    for key in ("train/loss", "test/loss", "test/PSNR", "test/SSIM"):
        _close(_series(port_dir, key), _series(jax_dir, key), key)
    assert len(want_params) == 2 and len(got_params) == 3
    for epoch, (g, w) in enumerate(zip(got_params, want_params)):
        w = params_from_jax(w)
        assert sorted(g) == sorted(w)
        for n in w:
            _close(g[n].numpy(), w[n].numpy(), f"epoch {epoch} {n}")


def test_adam_losses_match_jax(spectral):
    got = np.array(spectral["adam"]["port"][1])[:, 0]
    want = np.array(spectral["adam"]["jax"][1])[:, 0]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_best_and_latest_steps_match_jax(spectral):
    jax_dir = spectral["jax2"][0]
    port2, port3 = spectral["port2"][0], spectral["port3"][0]
    for which in ("best", "latest"):
        assert _steps(port2, which) == _steps(jax_dir, which), which
    losses = _series(port3, "test/loss")
    assert _steps(port3, "latest") == [2]
    assert _steps(port3, "best") == [int(np.argmin(losses))]
    assert CheckpointManager(os.path.join(port3, "best")).best_step() == \
        int(np.argmin(losses))


def test_resume_is_bit_exact_and_matches_jax(spectral):
    port3, straight, straight_params = spectral["port3"]
    port2, resumed, resumed_params = spectral["port_resumed"]
    assert resumed == straight[6:]
    for n, p in straight_params[-1].items():
        assert torch.equal(resumed_params[-1][n], p), n
    a = CheckpointManager(os.path.join(port3, "latest")).restore()
    b = CheckpointManager(os.path.join(port2, "latest")).restore()
    assert a["epoch"] == b["epoch"] == 2 and a["loader"] == b["loader"]
    assert a["extra"] == b["extra"] and a["loss"] == b["loss"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    sa, sb = a["opt_state"]["inner"], b["opt_state"]["inner"]
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    _close(np.array(resumed), np.array(spectral["jax_resumed"][1]),
           "resumed loss, grad_norm")
    _close(_series(port2, "test/loss"), _series(spectral["jax2"][0],
                                                "test/loss"), "test/loss")


def test_evaluate_matches_jax_and_the_logged_epoch(spectral):
    got, want = spectral["eval"]["port"], spectral["eval"]["jax"]
    _close(np.array(got), np.array(want), "evaluate (PSNR, SSIM)")
    port2 = spectral["port2"][0]
    best = _steps(port2, "best")[0]
    steps = [r for r in _records(port2) if "test/PSNR" in r]
    assert got == (steps[best]["test/PSNR"], steps[best]["test/SSIM"])


def test_histograms_match_jnp_histogram():
    g = np.random.default_rng(0)
    tensors = {"normal": g.normal(0, 0.02, (37, 11)).astype(np.float32),
               "steps": np.repeat(np.linspace(-1, 1, 9), 7).astype(
                   np.float32),
               "zeros": np.zeros((5, 3), np.float32),
               "constant": np.full(4, 1.5, np.float32)}
    got = trainer.histograms({k: torch.from_numpy(v)
                              for k, v in tensors.items()})
    for name, v in tensors.items():
        counts, edges = (t.numpy() for t in got[name])
        wc, we = (np.asarray(a) for a in jnp.histogram(v.ravel(), bins=64))
        assert edges.shape == (65,) and counts.shape == (64,)
        np.testing.assert_allclose(edges, we, rtol=0,
                                   atol=1e-6 * np.abs(we).max())
        assert counts.sum() == wc.sum() == v.size, name
        assert np.abs(counts - wc).max() <= 1, name


def test_checkpoint_manager_keeps_best_and_latest(tmp_path):
    best = CheckpointManager(tmp_path / "best", max_to_keep=1)
    latest = CheckpointManager(tmp_path / "latest", max_to_keep=1,
                               keep_best=False)
    for step, loss in enumerate((3.0, 1.0, 2.0)):
        for mgr in (best, latest):
            mgr.save(step, params={"w": torch.full((2,), float(step))},
                     opt_state={}, epoch=step, val_loss=loss,
                     loader_state={"epoch": step + 1, "batch": 0, "seed": 1})
    assert best.all_steps() == [1] and latest.all_steps() == [2]
    assert best.restore()["params"]["w"].tolist() == [1.0, 1.0]
    assert restore_params(tmp_path / "latest")["w"].tolist() == [2.0, 2.0]
    assert restore_params(tmp_path / "best" / "1")["w"].tolist() == [1.0, 1.0]
    assert latest.restore()["loader"]["epoch"] == 3
    assert not any(p.suffix == ".tmp" for p in tmp_path.rglob("*"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore()


@pytest.mark.parametrize("kw,match", [
    ({"mesh_data": 2}, "queue 1, item 8"),
    ({"mesh_context": 2}, "queue 1, item 8"),
    ({"mesh_context": 2, "image_size": 36}, "multiple of 8"),
    ({"shard_params": "data"}, "queue 1, item 8"),
    ({"remat": True, "remat_policy": "mxu+ew"}, "remat")])
def test_unsupported_settings_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        trainer.ModelTrainer("a", "b", "c", "d").train(
            Config(use_cpu=True, **kw))


def test_trainer_raises_without_cuda(monkeypatch):
    from underwater_image_restoration_torch import _device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.CudaUnavailableError):
        trainer.ModelTrainer("a", "b", "c", "d").train(Config())

