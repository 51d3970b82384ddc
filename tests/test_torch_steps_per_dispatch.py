"""The port's K-step dispatch (``make_train_step(k_steps=K)``,
``Config.steps_per_dispatch``, ``--steps-per-dispatch``) on the CPU, where
its steps run one after another (the plain version of the CUDA graph; the
graph itself is held against eager steps on the card, in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 15).

- ``k_steps=4`` against the JAX package's ``make_train_step(k_steps=4)``
  (a ``lax.scan`` of four steps), the small SpectralTransformer of
  ``test_torch_train.py`` (channels 8/16/32/64, one block a stage, one
  refinement block) at 32x32, batch 2, ``L1withColor``, SGD (lr 1e-2,
  momentum 0.9, clip 1.0), the same weights (the port's init carried to
  the JAX tree by the JAX package's converter): the four stacked losses
  and grad norms, and every parameter after them, to the tolerances of
  ``test_torch_train.py``'s trajectory test (1e-4 relative for the
  metrics, 1e-4 x max(1, max|ref|) for the parameters); and so does the
  port's ``k_steps=4`` over two gloo ranks at the same global batch, each
  rank its row of every batch (two processes spawned while the JAX steps
  compile; they import no JAX);
- ``k_steps=2`` against four single steps, bit-equal (the same ops in the
  same order), also with ``grad_accum=2``, and the AST at 32x32 with its
  DropPath at rate 0.1: two dispatches of two steps against four single
  steps, bit-equal parameters and an equal generator state;
- ``ModelTrainer`` with ``steps_per_dispatch=2`` against 1 over 3 batches
  (one group and a remainder), ``watch_freq=2``, ``print_freq=1``: the
  logged losses, the printed batches, the final parameters and the steps
  at which histograms are logged are equal (the JAX package's
  ``tests/test_train.py::test_trainer_steps_per_dispatch_equals_single``),
  and two epochs at ``steps_per_dispatch=2`` equal one and a resumed one
  bit for bit;
- ``validate`` refuses ``steps_per_dispatch`` 0, and ``make_train_step``
  ``k_steps`` 0; K > 1 with two data ranks, context ranks or sharded
  parameters passes under a world of two and outside ``torchrun`` meets
  the parallel settings' own refusal, which names ``torchrun``;
- an optimizer's state loads into one built with the other
  ``capturable`` flag, which each keeps, and a learning rate change
  changes ``hyperparameters()`` (what a captured graph bakes in).

The JAX step compiles with XLA's default options: with its backend
optimizations off (``test_torch_trainer.py``'s ``FAST_COMPILE``) the
compile halves but the four unoptimized steps take over a minute on one
core.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image

from test_torch_parallel import WORLD, _free_port, k_steps_rank

from underwater_image_restoration_tpu.losses import (
    LossFunction as JaxLossFunction,
)
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_tpu.train import optim as jax_optim
from underwater_image_restoration_tpu.train import trainer as jax_trainer
from underwater_image_restoration_torch.core.config import Config, validate
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    params_from_jax,
)
from underwater_image_restoration_torch.train import (
    CheckpointManager,
    get_optimizer,
    make_train_step,
    set_learning_rate,
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
TOL = 1e-4
K = 4


def _stack(batches):
    return (np.stack([r for r, _ in batches]),
            np.stack([f for _, f in batches]))


@pytest.fixture(scope="module")
def weights():
    port = init_model("SpectralTransformer", device="cpu", seed=3, **CFG)
    return convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})


@pytest.fixture(scope="module")
def batches():
    return [synthetic_pair_batch(2, 32, seed=20 + i) for i in range(K)]


def _spectral(flat):
    model = init_model("SpectralTransformer", device="cpu", seed=0, **CFG)
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_k_steps(weights, batches, tmp_path_factory):
    """The JAX ``make_train_step(k_steps=K)`` result (its metrics and final
    parameters in the port's layout), computed while two gloo ranks run the
    port's ``k_steps=K`` on their rows of the same batches (their metrics
    and final parameters)."""
    raw_k, ref_k = _stack(batches)
    out = tmp_path_factory.mktemp("k_steps_ranks")
    ctx = mp.spawn(k_steps_rank, args=(_free_port(), str(out), weights, CFG,
                                       raw_k, ref_k),
                   nprocs=WORLD, join=False)
    tx = jax_optim.get_optimizer("sgd", 1e-2)
    params = {"params": jax.tree.map(jnp.asarray, unflatten(weights))}
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros((), jnp.int32))
    jstep = jax_trainer.make_train_step(JaxSpectralTransformer(**CFG),
                                        JaxLossFunction("L1withColor"), tx,
                                        k_steps=K)
    args = (state, raw_k, ref_k, jax.random.PRNGKey(0))
    state, want = jax.device_get(jstep(*args))
    while not ctx.join():
        pass
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return want, params_from_jax(flatten(state.params["params"])), ranks


def _check_against_jax(got, params, jax_k_steps, what):
    want, ref, _ = jax_k_steps
    for key in ("loss", "grad_norm"):
        assert got[key].shape == (K,), key
        assert np.isfinite(got[key].numpy()).all(), key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=TOL,
                                   err_msg=f"{what} {key}")
    assert sorted(params) == sorted(ref)
    for name, p in params.items():
        np.testing.assert_allclose(
            p.numpy(), ref[name].numpy(),
            atol=TOL * max(1.0, float(ref[name].abs().max())),
            err_msg=f"{what} {name}")


def test_k_steps_match_jax_k_steps(weights, batches, jax_k_steps):
    raw_k, ref_k = _stack(batches)
    model = _spectral(weights)
    steps = make_train_step(model, LossFunction("L1withColor"),
                            get_optimizer("sgd", model.parameters(), 1e-2),
                            k_steps=K)
    got = steps(raw_k, ref_k)
    _check_against_jax(got, _params(model), jax_k_steps, "one rank")


def test_two_rank_k_steps_match_jax_k_steps(jax_k_steps):
    """The JAX package's own test_train_step_sharded_matches_single holds
    its one-device step equal to its two-device one; here the port's two
    ranks at the global batch meet the JAX K-step result."""
    for r, (got, params) in enumerate(jax_k_steps[2]):
        _check_against_jax(got, params, jax_k_steps, f"rank {r}")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_k_steps_equal_single_steps(weights, batches, grad_accum):
    def run(k):
        model = _spectral(weights)
        opt = get_optimizer("adam", model.parameters(), 3e-4)
        step = make_train_step(model, LossFunction("L1withColor"), opt,
                               grad_accum=grad_accum, k_steps=k)
        if k == 1:
            ms = [step(raw, ref) for raw, ref in batches]
            ms = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        else:
            parts = [step(*_stack(batches[i:i + k]))
                     for i in range(0, len(batches), k)]
            ms = {key: torch.cat([m[key] for m in parts])
                  for key in parts[0]}
        return ms, _params(model), opt.state_dict()

    one, p1, s1 = run(1)
    two, p2, s2 = run(2)
    assert one.keys() == two.keys() == {"loss", "grad_norm"}
    for key in one:
        assert two[key].shape == (K,)
        assert torch.equal(one[key], two[key]), key
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n
    for i, st in s1["inner"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, s2["inner"]["state"][i][key]), (i, key)


def test_ast_droppath_k_steps_equal_single_steps(batches):
    def run(k):
        model = init_model("AST", device="cpu", seed=1, img_size=32,
                           embed_dim=8, win_size=4, drop_path_rate=0.1)
        gen = torch.Generator().manual_seed(5)
        step = make_train_step(model, LossFunction("L1withColor"),
                               get_optimizer("adam", model.parameters(),
                                             3e-4),
                               generator=gen, k_steps=k)
        if k == 1:
            losses = [step(raw, ref)["loss"] for raw, ref in batches]
        else:
            losses = [v for i in range(0, K, k)
                      for v in step(*_stack(batches[i:i + k]))["loss"]]
        return torch.stack(losses), _params(model), gen.get_state()

    l1, p1, g1 = run(1)
    l2, p2, g2 = run(2)
    assert torch.isfinite(l1).all()
    assert torch.equal(l1, l2)
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n
    assert torch.equal(g1, g2)
    # the draws moved the generator: DropPath was active
    assert not torch.equal(g1, torch.Generator().manual_seed(5).get_state())


def test_trainer_steps_per_dispatch_equals_single(weights, tmp_path,
                                                  monkeypatch, capsys):
    raw, ref = synthetic_pair_batch(6, 32, seed=5)
    dirs = []
    for split, n in (("train", 6), ("test", 2)):
        for sub, arr in (("a", raw), ("b", ref)):
            d = tmp_path / "data" / split / sub
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(arr[i]).save(d / f"{i}_img_.png")
            dirs.append(str(d))
    monkeypatch.setattr(trainer, "init_model",
                        lambda arch, **k: _spectral(weights))

    def run(k):
        cfg = Config(
            arch="SpectralTransformer", lossf="L1", lr=1e-3, max_epoch=1,
            train_batch_size=2, test_batch_size=2, image_size=32,
            mesh_data=1, use_wandb=False, workers=1, print_freq=1, seed=3,
            steps_per_dispatch=k, optim="sgd", watch_freq=2,
            compute_dtype="float32", use_cpu=True,
            checkpoint_dir=str(tmp_path / f"ck{k}"))
        capsys.readouterr()
        model, _ = trainer.ModelTrainer(*dirs).train(cfg)
        printed = [ln for ln in capsys.readouterr().out.splitlines()
                   if ln.startswith("Batch ")]
        run_dir = os.path.join(cfg.checkpoint_dir,
                               os.listdir(cfg.checkpoint_dir)[0])
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train/loss"] for r in recs if "train/loss" in r]
        hist_steps = sorted({r["_step"] for r in recs
                             if any(key.startswith(("parameters/",
                                                    "gradients/"))
                                    for key in r)})
        return _params(model), losses, hist_steps, printed

    p1, l1, h1, s1 = run(1)
    p2, l2, h2, s2 = run(2)
    assert len(l1) == 3 and np.isfinite(l1).all()
    assert h1 == h2 == [0, 2]
    assert l1 == l2
    assert s1 == s2 and len(s1) == 3
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n


@pytest.mark.parametrize("kw,match", [
    ({"steps_per_dispatch": 0}, "1 or more"),
    ({"steps_per_dispatch": 2, "mesh_data": 2}, "torchrun"),
    ({"steps_per_dispatch": 2, "mesh_context": 2}, "torchrun"),
    ({"steps_per_dispatch": 4, "shard_params": "data"}, "torchrun")])
def test_validate_refuses(kw, match, monkeypatch):
    """K = 0 is refused; K > 1 with ranks outside ``torchrun`` meets the
    parallel settings' own refusal, as K = 1 does."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=match):
        validate(Config(**kw))


def test_validate_takes_k_steps_on_one_rank():
    assert validate(Config(steps_per_dispatch=4)).steps_per_dispatch == 4


@pytest.mark.parametrize("kw", [
    {"mesh_data": 2}, {"mesh_context": 2}, {"shard_params": "data"},
    {"mesh_context": 2, "shard_params": "context"}])
def test_validate_takes_k_steps_with_ranks(kw, monkeypatch):
    """Under a world of two (as ``torchrun`` sets it) K > 1 runs with data
    ranks, context ranks and sharded parameters."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = validate(Config(steps_per_dispatch=4, image_size=256, **kw))
    assert cfg.steps_per_dispatch == 4


def test_make_train_step_refuses_zero_steps(weights):
    model = _spectral(weights)
    with pytest.raises(ValueError, match="1 or more"):
        make_train_step(model, LossFunction("L1"),
                        get_optimizer("sgd", model.parameters(), 1e-2),
                        k_steps=0)


def test_optimizer_state_keeps_its_capturable_flag(weights, batches):
    """A checkpoint of eager Adam resumes in a capturable one (the K-step
    dispatch's) and the other way round: each keeps its own flag, and the
    learning rate is part of what a captured graph depends on."""
    model = _spectral(weights)
    plain = get_optimizer("adam", model.parameters(), 3e-4)
    make_train_step(model, LossFunction("L1"), plain)(*batches[0])
    cap = get_optimizer("adam", model.parameters(), 3e-4, capturable=True)
    cap.load_state_dict(plain.state_dict())
    assert all(g["capturable"] for g in cap.param_groups)
    back = get_optimizer("adam", model.parameters(), 3e-4)
    back.load_state_dict(cap.state_dict())
    assert not any(g["capturable"] for g in back.param_groups)
    for st in back.inner.state.values():
        assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
    before = cap.hyperparameters()
    set_learning_rate(cap, 7.5e-5)
    assert cap.hyperparameters() != before


def test_trainer_resume_with_steps_per_dispatch_is_bit_exact(
        weights, tmp_path, monkeypatch):
    """Two epochs at ``steps_per_dispatch=2`` equal one epoch and a resumed
    one bit for bit (parameters, optimizer state)."""
    raw, ref = synthetic_pair_batch(5, 32, seed=6)
    dirs = []
    for split, n in (("train", 5), ("test", 2)):
        for sub, arr in (("a", raw), ("b", ref)):
            d = tmp_path / "data" / split / sub
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(arr[i]).save(d / f"{i}.png")
            dirs.append(str(d))
    monkeypatch.setattr(trainer, "init_model",
                        lambda arch, **k: _spectral(weights))
    cfg = Config(lossf="L1", lr=1e-3, train_batch_size=2, test_batch_size=2,
                 image_size=32, mesh_data=1, use_wandb=False, workers=1,
                 print_freq=100, watch_freq=0, steps_per_dispatch=2,
                 compute_dtype="float32", use_cpu=True)
    runs = {}
    for name, epochs in (("straight", 2), ("resumed", 1)):
        ckpt = tmp_path / name
        trainer.ModelTrainer(*dirs).train(cfg.replace(
            checkpoint_dir=str(ckpt), max_epoch=epochs))
        runs[name] = str(next(ckpt.iterdir()))
    trainer.ModelTrainer(*dirs).train(cfg.replace(
        max_epoch=2, resume=runs["resumed"]))
    a, b = (CheckpointManager(os.path.join(runs[n], "latest")).restore()
            for n in ("straight", "resumed"))
    assert a["epoch"] == b["epoch"] == 1
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    sa, sb = a["opt_state"]["inner"]["state"], b["opt_state"]["inner"]["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
