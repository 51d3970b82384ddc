"""The port's data parallelism and parameter sharding (``core/meshes.py``,
the ``parallel=`` of ``train.make_train_step``, ``ModelTrainer`` under
``mesh_data`` and ``shard_params='data'``) on the CPU, in f32, over two
ranks of ``gloo`` (one spawn of two processes for the module; the
single-process references run here meanwhile):

- a 2-rank data-parallel step (each rank its rows of the global batch of 4,
  ``DataParallel.rows``) equals the one-process step at the global batch,
  losses and grad norms within 1e-6 relative, and every parameter after 2
  SGD steps (momentum 0.9: the update is linear in the gradient, so the
  tolerance measures the collectives' numerics, as the JAX package's
  parallel tests do) within 1e-6 of the parameters' max|ref| (relative in
  the infinity norm): for a B*C-divided loss (``L1withColor``),
  an Adaptive loss (its weights from the global batch's detached losses)
  and the AST with DropPath active (rate 0.3; each rank draws the global
  batch's decisions and keeps its rows);
- (the one-process steps of the two Spectral cases are held against the
  JAX package's step over a data mesh in ``test_torch_parallel_jax.py``:
  its compile alone takes about 25 s a loss on one core);
- FSDP2 (``shard_model``): parameters after 2 steps equal the data-parallel
  ones within 1e-6, and the blocks' fused ops were given plain tensors,
  never a DTensor;
- ``ModelTrainer`` with ``mesh_data=2, shard_params='data'``: a 2-epoch run
  equals its first epoch's checkpoint resumed for a second bit for bit
  (checkpoints in the single-device format, the resume through
  ``load_full_state``); the checkpoint loads strict into a single-device
  model, and the single-device ``ModelTrainer.evaluate`` of it gives the
  PSNR and SSIM the 2-rank run logged;
- the 2-rank run's validation (3 test pairs at batch 2: in the padded final
  batch rank 1 holds only padding) logs the loss, PSNR and SSIM of the
  one-process ``ModelTrainer`` on the same data within 1e-6 relative, and
  the logged loss is the one-device validation of the checkpoint within
  1e-6;
- the K-step dispatch over the two ranks (``make_train_step(k_steps=2)``,
  on the CPU its steps one after another): one call of two steps equals
  the two single steps above bit for bit (losses, grad norms, every
  parameter, the DropPath generator's state) for ``L1withColor``, the
  Adaptive loss and the AST with DropPath, and with ``grad_accum=2``;
  FSDP2 at K = 2 equals FSDP2 at K = 1; the collectives a step issues
  (``DataParallel.record_collectives``) are the same on both ranks: the
  gradients' flat ``all_reduce_`` of every parameter's elements and the
  loss's ``sum``, after the Adaptive loss's ``mean`` of its two detached
  terms (the tape the card's graphs are cut at);
- ``ModelTrainer`` over the two ranks at ``steps_per_dispatch=2`` against
  1 (replicated parameters, 3 batches an epoch: a group of two and a
  remainder): the logged losses and the final parameters equal, and the
  K = 1 run's first epoch resumed at K = 2 gives the K = 2 run's second
  (the counterpart of the JAX ``tests/test_train.py``'s
  ``test_trainer_steps_per_dispatch_equals_single``, run there under
  ``mesh_data=2``);
- ``validate`` refuses ``--mesh-context 2`` for SpectralTransformer citing
  its ROADMAP item and an image side the context size does not divide, and
  ``--mesh-data 2``, ``--mesh-context 2`` or ``--shard-params`` without a
  process group naming ``torchrun``.

The spawned ranks import this module, which imports no JAX.
"""
import contextlib
import json
import os
import pathlib
import shutil
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from underwater_image_restoration_torch.core import meshes
from underwater_image_restoration_torch.core.config import Config, validate
from underwater_image_restoration_torch.data import (
    get_dataloaders,
    synthetic_pair_batch,
)
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops import fused_gdfn, fused_mdta
from underwater_image_restoration_torch.tools.convert import params_from_jax
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
    restore_params,
)
from underwater_image_restoration_torch.train import trainer

# the JAX package's _CP_MODELS sizes (tests/test_parallel.py:158), the AST
# with DropPath at 0.3
SPECTRAL = dict(num_blocks=(1, 1, 1, 1), channels=(4, 8, 16, 32),
                num_heads=(1, 2, 4, 8), num_refinement=1)
CASES = {
    "l1withcolor": ("SpectralTransformer", SPECTRAL, "L1withColor", 16),
    "adaptive": ("SpectralTransformer", SPECTRAL,
                 "AdaptiveLuminanceCharbonnier", 16),
    "ast_droppath": ("AST", dict(img_size=32, embed_dim=8,
                                 drop_path_rate=0.3), "L1withColor", 32),
}
BATCH, STEPS, WORLD = 4, 2, 2
TOL = 1e-6
TRAIN = dict(image_size=16, train_batch_size=4, test_batch_size=2,
             compute_dtype="float32", use_cpu=True, mesh_data=WORLD,
             shard_params="data", lossf="L1withColor", optim="sgd", lr=1e-2,
             workers=1, print_freq=100, use_wandb=False, watch_freq=0)


def _batches(size):
    return [synthetic_pair_batch(BATCH, size, seed=10 + s)
            for s in range(STEPS)]


def run_steps(case, dp=None, shard=False, k_steps=1, grad_accum=1):
    """STEPS SGD steps of ``case`` on the global batches (the rank's rows
    under ``dp``), single steps or calls of ``k_steps``: ([(loss,
    grad_norm)], the full parameters, the DropPath generator's state and
    the collectives the steps issued)."""
    arch, kw, loss, size = CASES[case]
    model = init_model(arch, device="cpu", seed=3, **kw)
    if shard:
        meshes.shard_model(model, dp)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    gen = torch.Generator().manual_seed(7)
    step = make_train_step(model, LossFunction(loss), opt, generator=gen,
                           parallel=dp, grad_accum=grad_accum,
                           k_steps=k_steps)
    rows = slice(None) if dp is None else dp.rows(BATCH, grad_accum)
    batches = [(raw[rows], ref[rows]) for raw, ref in _batches(size)]
    record = (contextlib.nullcontext([]) if dp is None
              else dp.record_collectives())
    with record as tape:
        if k_steps == 1:
            metrics = [tuple(float(v) for v in step(*b).values())
                       for b in batches]
        else:
            metrics = []
            for i in range(0, STEPS, k_steps):
                group = batches[i:i + k_steps]
                out = step(np.stack([r for r, _ in group]),
                           np.stack([f for _, f in group]))
                metrics += zip(*(v.tolist() for v in out.values()))
    if shard:
        params = meshes.full_state(model, opt)[0]
    else:
        params = {n: p.detach().clone() for n, p in model.state_dict().items()}
    return metrics, params, {"generator": gen.get_state(), "tape": tape}


def _small_init_model(arch, **kw):
    return init_model(arch, **{**kw, **SPECTRAL})


def _train(data, ckpt, on_epoch_end=None, **kw):
    trainer.ModelTrainer(*data).train(
        Config(checkpoint_dir=ckpt, **TRAIN).replace(**kw),
        on_epoch_end=on_epoch_end)
    return kw.get("resume") or os.path.join(ckpt, os.listdir(ckpt)[0])


# the K-step cases: (the CASES entry, FSDP2, grad_accum)
K_CASES = {**{case: (case, False, 1) for case in CASES},
           "accum": ("l1withcolor", False, 2),
           "fsdp": ("l1withcolor", True, 1)}
# the trainer's K-step runs: 6 train pairs at batch 2 (3 batches an epoch)
# over replicated parameters
K_TRAIN = dict(train_batch_size=2, shard_params="", max_epoch=2)


def _worker(rank, port, out, data):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dp = meshes.init_data_parallel(backend="gloo", device="cpu")
    res = {case: run_steps(case, dp) for case in CASES}
    res["accum"] = run_steps("l1withcolor", dp, grad_accum=2)
    # the K-step dispatch: one call of STEPS steps
    for name, (case, shard, accum) in K_CASES.items():
        res["k", name] = run_steps(case, dp, shard=shard, k_steps=STEPS,
                                   grad_accum=accum)
    res["tapes"] = [None] * WORLD
    dist.all_gather_object(res["tapes"], {
        name: res["k", name][2]["tape"] for name in K_CASES})
    # FSDP, recording the types the blocks' fused ops are given
    seen = set()

    def recorded(fn):
        def call(*args, **kw):
            seen.update(type(a).__name__ for a in args
                        if isinstance(a, torch.Tensor))
            return fn(*args, **kw)
        return call

    real = fused_mdta.ln_mdta, fused_gdfn.ln_gdfn
    fused_mdta.ln_mdta, fused_gdfn.ln_gdfn = (recorded(f) for f in real)
    try:
        res["fsdp"] = run_steps("l1withcolor", dp, shard=True)
    finally:
        fused_mdta.ln_mdta, fused_gdfn.ln_gdfn = real
    res["fsdp_inputs"] = sorted(seen)
    trainer.init_model = _small_init_model
    root = pathlib.Path(out).parent
    straight, resumed = root / "straight", root / "resumed"

    def keep_first_epoch(epoch, model, loss):
        if epoch == 0 and dp.is_main:  # the run as a 1-epoch run left it
            run = next(straight.iterdir())
            shutil.copytree(run, resumed / run.name)

    res["straight"] = _train(data, str(straight), max_epoch=2,
                             on_epoch_end=keep_first_epoch)
    dp.barrier()
    res["resumed"] = _train(data, str(resumed), max_epoch=2,
                            resume=str(next(resumed.iterdir())))
    # the trainer at steps_per_dispatch 2 and 1; the K = 1 run's first
    # epoch resumed at K = 2
    k_root = root / "k"

    def keep_k1_first_epoch(epoch, model, loss):
        if epoch == 0 and dp.is_main:
            run = next((k_root / "1").iterdir())
            shutil.copytree(run, k_root / "resumed" / run.name)

    for k in (1, 2):
        res["trainer_k", k] = _train(
            data, str(k_root / str(k)), steps_per_dispatch=k,
            on_epoch_end=keep_k1_first_epoch if k == 1 else None, **K_TRAIN)
    dp.barrier()
    res["trainer_k", "resumed"] = _train(
        data, str(k_root / "resumed"), steps_per_dispatch=2,
        resume=str(next((k_root / "resumed").iterdir())), **K_TRAIN)
    if dp.is_main:
        torch.save(res, out)
    meshes.close_data_parallel(dp)


def k_steps_rank(rank, port, out_dir, flat, cfg, raw_k, ref_k):
    """A rank of a two-rank ``make_train_step(k_steps=K)`` call
    (``tests/test_torch_steps_per_dispatch.py``): the SpectralTransformer of
    ``cfg`` with the JAX-layout parameters ``flat``, ``L1withColor``, SGD
    at 1e-2, on the rank's rows of the K stacked global batches; its (K,)
    metrics and final parameters in ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dp = meshes.init_data_parallel(backend="gloo", device="cpu")
    model = init_model("SpectralTransformer", device="cpu", seed=0, **cfg)
    model.load_state_dict(params_from_jax(flat), strict=True)
    steps = make_train_step(model, LossFunction("L1withColor"),
                            get_optimizer("sgd", model.parameters(), 1e-2),
                            parallel=dp, k_steps=len(raw_k))
    rows = dp.rows(raw_k.shape[1])
    got = steps(raw_k[:, rows], ref_k[:, rows])
    torch.save((got, {n: p.detach() for n, p in model.named_parameters()}),
               os.path.join(out_dir, f"rank{rank}.pt"))
    meshes.close_data_parallel(dp)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_pairs(root):
    for split, n, seed in (("train", 6, 0), ("test", 3, 1)):
        raw, ref = synthetic_pair_batch(n, 16, seed=seed)
        for sub, arr in (("a", raw), ("b", ref)):
            d = root / split / sub
            d.mkdir(parents=True)
            for i, img in enumerate(arr):
                Image.fromarray(img).save(d / f"{i:03d}.png")
    return [str(root / s / x) for s in ("train", "test") for x in "ab"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, the one-process references (computed while
    the ranks run) and the one-process trainer's run directory."""
    root = tmp_path_factory.mktemp("parallel")
    data = _write_pairs(root / "data")
    out = str(root / "ranks.pt")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = mp.spawn(_worker, args=(_free_port(), out, data), nprocs=WORLD,
                   join=False)
    init = trainer.init_model
    try:
        ref = {case: run_steps(case) for case in CASES}
        trainer.init_model = _small_init_model
        ref["single"] = _train(data, str(root / "single"), max_epoch=2,
                               mesh_data=1, shard_params="")
        while not ctx.join():
            pass
    finally:
        trainer.init_model = init
        torch.set_num_threads(n)
    return torch.load(out, weights_only=False), ref, data


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1e-30, float(np.abs(want).max())),
        err_msg=what)


def _close_params(got, want, tol, what):
    """Every parameter within ``tol`` of the model's max|ref| (relative in
    the infinity norm over all the parameters: a tensor of values near 0,
    such as a LayerNorm bias two small steps from its zero init, carries
    the summation-order roundoff of its gradient at that scale)."""
    assert sorted(got) == sorted(want), what
    scale = max(float(w.abs().max()) for w in want.values())
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"{what} {n}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_parallel_step_equals_one_process(runs, case):
    got, ref, _ = runs
    (gm, gp, _), (wm, wp, _) = got[case], ref[case]
    assert len(gm) == len(wm) == STEPS
    for (gl, gn), (wl, wn) in zip(gm, wm):
        np.testing.assert_allclose([gl, gn], [wl, wn], rtol=TOL, atol=0,
                                   err_msg=case)
    _close_params(gp, wp, TOL, case)


def test_fsdp_step_equals_data_parallel(runs):
    got = runs[0]
    (fm, fp, _), (dm, dp, _) = got["fsdp"], got["l1withcolor"]
    np.testing.assert_allclose(np.array(fm), np.array(dm), rtol=TOL, atol=0)
    _close_params(fp, dp, TOL, "fsdp")
    # the blocks' fused ops saw plain tensors and parameters
    assert got["fsdp_inputs"] and "DTensor" not in got["fsdp_inputs"]


@pytest.mark.parametrize("name", sorted(K_CASES))
def test_k_steps_equal_single_steps(runs, name):
    """One call of two steps over the two ranks equals two single steps bit
    for bit, and the steps issued the same collectives on both ranks: the
    tape the card's graphs are cut at."""
    got = runs[0]
    (km, kp, kx) = got["k", name]
    (sm, sp, sx) = got[name]
    assert len(km) == len(sm) == STEPS and np.isfinite(km).all()
    assert km == sm, name
    assert sorted(kp) == sorted(sp)
    for n in sp:
        assert torch.equal(kp[n], sp[n]), (name, n)
    assert torch.equal(kx["generator"], sx["generator"])
    if name == "ast_droppath":  # DropPath drew: the generator moved
        assert not torch.equal(kx["generator"],
                               torch.Generator().manual_seed(7).get_state())
    tapes = [t[name] for t in got["tapes"]]
    assert tapes[0] == tapes[1] == kx["tape"]
    if name == "fsdp":  # FSDP2's collectives are its own, not DataParallel's
        assert kx["tape"] == [("sum", "float32", 1)] * STEPS
        return
    case = K_CASES[name][0]
    arch, kw, loss, _ = CASES[case]
    numel = sum(p.numel() for p in init_model(arch, device="cpu", **kw)
                .parameters() if p.requires_grad)
    one = [("all_reduce_", "float32", numel), ("sum", "float32", 1)]
    if loss.startswith("Adaptive"):
        one = [("mean", "float32", 2)] + one
    assert kx["tape"] == one * STEPS


def test_two_rank_trainer_steps_per_dispatch_equals_single(runs):
    """``ModelTrainer`` over two ranks at ``steps_per_dispatch=2`` logs the
    losses of the run at 1 and ends at its parameters; the K = 1 run's first
    epoch resumed at K = 2 ends at them too."""
    got = runs[0]
    runs_k = {k: got["trainer_k", k] for k in (1, 2, "resumed")}
    losses = {k: [r["train/loss"] for r in _records(run)
                  if "train/loss" in r] for k, run in runs_k.items()}
    assert len(losses[1]) == 6 and np.isfinite(losses[1]).all()
    assert losses[2] == losses[1] == losses["resumed"]
    states = {k: trainer.CheckpointManager(
        os.path.join(run, "latest")).restore() for k, run in runs_k.items()}
    assert states[1]["epoch"] == states[2]["epoch"] == 1
    assert states["resumed"]["epoch"] == 1
    for n, v in states[1]["params"].items():
        assert torch.equal(states[2]["params"][n], v), n
        assert torch.equal(states["resumed"]["params"][n], v), n


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fsdp_trainer_resume_is_bit_exact(runs):
    got = runs[0]
    a = trainer.CheckpointManager(
        os.path.join(got["straight"], "latest")).restore()
    b = trainer.CheckpointManager(
        os.path.join(got["resumed"], "latest")).restore()
    assert a["epoch"] == b["epoch"] == 1 and a["loader"] == b["loader"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    sa, sb = a["opt_state"]["inner"], b["opt_state"]["inner"]
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    train = [r["train/loss"] for r in _records(got["straight"])
             if "train/loss" in r]
    resumed = [r["train/loss"] for r in _records(got["resumed"])
               if "train/loss" in r]
    assert train == resumed


def test_fsdp_checkpoint_loads_on_one_device(runs, monkeypatch):
    got, _, data = runs
    run = got["resumed"]
    model = _small_init_model("SpectralTransformer", device="cpu")
    model.load_state_dict(restore_params(os.path.join(run, "best")),
                          strict=True)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    state = trainer.CheckpointManager(os.path.join(run, "latest")).restore()
    opt.load_state_dict(state["opt_state"])
    monkeypatch.setattr(trainer, "init_model", _small_init_model)
    cfg = Config(**{**TRAIN, "mesh_data": 1, "shard_params": ""})
    psnr, ssim = trainer.ModelTrainer(*data).evaluate(
        cfg, os.path.join(run, "best"))
    best = trainer.CheckpointManager(os.path.join(run, "best")).best_step()
    logged = [r for r in _records(run) if "test/PSNR" in r][best]
    np.testing.assert_allclose([psnr, ssim],
                               [logged["test/PSNR"], logged["test/SSIM"]],
                               rtol=1e-6)


def test_validation_equals_one_process(runs):
    got, ref, data = runs
    test = [[r[k] for k in ("test/loss", "test/PSNR", "test/SSIM")]
            for r in _records(got["straight"]) if "test/loss" in r]
    want = [[r[k] for k in ("test/loss", "test/PSNR", "test/SSIM")]
            for r in _records(ref["single"]) if "test/loss" in r]
    assert len(test) == len(want) == 2 and np.isfinite(test).all()
    np.testing.assert_allclose(test, want, rtol=TOL, atol=0)
    # the logged loss is the one-device validation of the epoch's parameters
    model = _small_init_model("SpectralTransformer", device="cpu")
    ckpt = trainer.CheckpointManager(
        os.path.join(got["straight"], "latest"))
    model.load_state_dict(ckpt.restore()["params"], strict=True)
    _, loader = get_dataloaders(*data, batch_size=4, test_batch_size=2,
                                image_size=16)
    loss, psnr, ssim = trainer.validate_loader(
        trainer.make_eval_step(model, LossFunction("L1withColor")), loader)
    np.testing.assert_allclose([loss, psnr, ssim], test[-1], rtol=TOL)


@pytest.mark.parametrize("kw,match", [
    ({"mesh_context": 2}, "torchrun"),
    ({"mesh_context": 2, "image_size": 36}, "multiple of 8"),
    ({"mesh_context": 16, "image_size": 16}, "too few rows a rank"),
    ({"arch": "AST", "mesh_context": 2, "image_size": 33},
     "not divisible by context-parallel size 2"),
    ({"mesh_data": 2}, "torchrun"),
    ({"shard_params": "data"}, "torchrun"),
    ({"shard_params": "context"}, "torchrun"),
    ({"arch": "NewModel", "mesh_context": 2, "image_size": 32},
     "torchrun")])
def test_validate_refuses(kw, match, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=match):
        validate(Config(use_cpu=True, **kw))


def test_rows_of_the_global_batch():
    rows = [meshes.DataParallel(rank=r, world=2).rows(8, grad_accum=2)
            for r in range(2)]
    assert [r.tolist() for r in rows] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert meshes.DataParallel(rank=1, world=2).rows(4).tolist() == [2, 3]
    with pytest.raises(ValueError, match="divisible"):
        meshes.DataParallel(rank=0, world=2).rows(6, grad_accum=2)
