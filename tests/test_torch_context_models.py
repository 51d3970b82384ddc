"""Context and tensor parallelism of the New* family and the AST through the
train step and ``ModelTrainer``, on the CPU in f32 over two ranks of
``gloo`` with ``mesh_context=2`` (one spawn of two processes for the
module; the one-process references run here meanwhile):

- the context-parallel train step (each rank its band of the images' rows,
  two SGD steps, momentum 0.9, global batch 4 at 32x32, embed 8) equals the
  one-process step, losses and grad norms within 1e-6 relative and every
  parameter within 1e-6 of max|ref|, for NewModel-Fourier (the distributed
  (L, C)-token FFT and FDFP's ``sharded_fft2``), NewModel-Wavelet (the
  band's DWT, the gathered IDWT), NewBigFRFNModel (FRFN's halo'd taps) and
  the AST;
- ``--shard-params context`` (``parallel.shard_params_tp``, FSDP2 over the
  context dimension): the AST's step equals the context-parallel step
  within 1e-6, its blocks' fused ops see plain tensors, and its
  checkpoint (``full_state``) loads strict into a single-device model
  whose forward equals the sharded model's gathered output;
- ``ModelTrainer`` with ``mesh_context=2, shard_params='context'`` (a small
  AST without DropPath): two epochs log the loss, PSNR and SSIM of the
  one-process run within 1e-6 relative; the first epoch's checkpoint
  resumed for the second gives the straight run's checkpoint bit for bit;
  the single-device ``ModelTrainer.evaluate`` of its best checkpoint gives
  the PSNR and SSIM it logged.

- the AST's context-parallel forward (gathered) equals the JAX CP model's
  ``apply`` over ``make_mesh(data=4, context=2)`` (as
  ``tests/test_parallel.py`` builds it; weights carried across by
  ``convert_state_dict``): at the reference init within 1e-4 absolute, and
  with the weights redrawn informative (as ``tests/test_torch_ast.py``
  draws them; |y| ~ 50) within that test's 3e-5 of max(1, max|ref|).

The spawned ranks import this module, which imports JAX only inside the
tests.
"""
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_parallel import _close_params, _free_port, _records
from underwater_image_restoration_torch.core import meshes
from underwater_image_restoration_torch.core.config import Config
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import ast as ast_model
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.models.blocks import (
    WindowAttentionSparse,
)
from underwater_image_restoration_torch.parallel import (
    gather_replicated,
    shard_params_tp,
)
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
    restore_params,
)
from underwater_image_restoration_torch.train import trainer

WORLD, BATCH, STEPS, SIZE = 2, 4, 2, 32
TOL = 1e-6
SMALL = dict(img_size=SIZE, embed_dim=8)
CASES = {
    "newmodel_fourier": ("NewModel", dict(SMALL, use_dwt="Fourier")),
    "newmodel_wavelet": ("NewModel", dict(SMALL, use_dwt="Wavelet")),
    "newbigfrfn_fourier": ("NewBigFRFNModel", dict(SMALL, use_dwt="Fourier")),
    "ast": ("AST", dict(SMALL)),
}
# the JAX functions compiled with XLA's backend optimizations off (the same
# program, a fraction of the compile time on one core)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TRAIN = dict(image_size=SIZE, train_batch_size=4, test_batch_size=2,
             compute_dtype="float32", use_cpu=True, mesh_context=WORLD,
             shard_params="context", lossf="L1withColor", optim="sgd",
             lr=1e-2, workers=1, print_freq=100, use_wandb=False,
             watch_freq=0, arch="AST")


def _batches():
    return [synthetic_pair_batch(BATCH, SIZE, seed=10 + s)
            for s in range(STEPS)]


@torch.no_grad()
def _informative(model, seed):
    """The AST test's weights: Linears N(0, 1/fan_in) with biases of std
    0.1, bias tables of std 1, mix weights (0.3, -0.4), LayerNorms near
    one and zero, so every branch is O(1) and the attention far from
    uniform."""
    g = torch.Generator().manual_seed(seed)

    def n(p, std):
        p.copy_(torch.randn(p.shape, generator=g) * std)

    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            n(m.weight, m.in_features ** -0.5)
            n(m.bias, 0.1)
        elif isinstance(m, WindowAttentionSparse):
            n(m.relative_position_bias_table, 1.0)
            if m.w is not None:
                m.w.copy_(torch.tensor([0.3, -0.4]))
    for name, p in model.named_parameters():
        if ".norm" in name:
            n(p, 0.1)
            if name.endswith("weight"):
                p.add_(1.0)
    return model


# the forward's weights: the reference init, or redrawn informative; the
# limits: 1e-4 absolute, and the single-device AST test's 3e-5 of
# max(1, max|ref|) where the informative output reaches |y| ~ 50 (f32 sums
# in another order through 18 blocks, as there)
FORWARD_TOL = {"reference_init": (1e-4, False), "informative": (3e-5, True)}


def _ast(weights, cp=None):
    model = init_model("AST", device="cpu", seed=3, cp=cp, **SMALL)
    return _informative(model, 103) if weights == "informative" else model


def _forward_input():
    return np.random.default_rng(1).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)
                                            ).astype(np.float32)


def run_steps(case, dp=None, shard=False):
    """STEPS SGD steps of ``case`` on the global batches (the rank's band
    under ``dp``): ([(loss, grad_norm)], the full parameters, the model)."""
    arch, kw = CASES[case]
    model = init_model(arch, device="cpu", seed=3,
                       cp=None if dp is None else dp.cp, **kw)
    if shard:
        shard_params_tp(model, dp)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    step = make_train_step(model, LossFunction("L1withColor"), opt,
                           generator=torch.Generator().manual_seed(7),
                           parallel=dp)
    metrics = [tuple(float(v) for v in step(raw, ref).values())
               for raw, ref in _batches()]
    if shard:
        params = meshes.full_state(model, opt)[0]
    else:
        params = {n: p.detach().clone() for n, p in model.state_dict().items()}
    return metrics, params, model


def _small_init_model(arch, **kw):
    """The trainer's model, small, without DropPath (a resumed run draws a
    new DropPath stream, as the JAX trainer's does)."""
    return init_model(arch, **{**kw, "embed_dim": 8, "drop_path_rate": 0.0})


def _train(data, ckpt, on_epoch_end=None, **kw):
    trainer.ModelTrainer(*data).train(
        Config(checkpoint_dir=ckpt, **TRAIN).replace(**kw),
        on_epoch_end=on_epoch_end)
    return kw.get("resume") or os.path.join(ckpt, os.listdir(ckpt)[0])


def _eval_input():
    x = synthetic_pair_batch(2, SIZE, seed=20)[0]
    return (torch.as_tensor(x).float() / 255.0 * 2 - 1).permute(0, 3, 1, 2)


def _worker(rank, port, out_dir, data):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dp = meshes.init_data_parallel(backend="gloo", device="cpu",
                                   mesh_context=WORLD)
    res = {case: run_steps(case, dp)[:2] for case in CASES}
    # --shard-params context, recording the types the fused ops are given
    seen = set()

    def recorded(fn):
        def call(*args, **kw):
            seen.update(type(a).__name__ for a in args
                        if isinstance(a, torch.Tensor))
            return fn(*args, **kw)
        return call

    real = ast_model.ln_leff
    ast_model.ln_leff = recorded(real)
    try:
        metrics, params, model = run_steps("ast", dp, shard=True)
    finally:
        ast_model.ln_leff = real
    model.eval()
    with torch.no_grad():
        x = _eval_input()
        out = gather_replicated(model(x[:, :, dp.cp.band(SIZE)]), dp.cp, 2)
    res["tp"] = (metrics, params, out, sorted(seen))
    x = torch.from_numpy(_forward_input()).permute(0, 3, 1, 2)
    with torch.no_grad():
        res["forward"] = {w: gather_replicated(
            _ast(w, dp.cp)(x[:, :, dp.cp.band(SIZE)]), dp.cp, 2).numpy()
            for w in FORWARD_TOL}
    trainer.init_model = _small_init_model
    root = pathlib.Path(out_dir)
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
    if dp.is_main:
        torch.save(res, root / "ranks.pt")
    meshes.close_data_parallel(dp)


def _write_pairs(root):
    from PIL import Image

    for split, n, seed in (("train", 6, 0), ("test", 3, 1)):
        raw, ref = synthetic_pair_batch(n, SIZE, seed=seed)
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
    root = tmp_path_factory.mktemp("context_models")
    data = _write_pairs(root / "data")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = mp.spawn(_worker, args=(_free_port(), str(root), data),
                   nprocs=WORLD, join=False)
    init = trainer.init_model
    try:
        ref = {case: run_steps(case)[:2] for case in CASES}
        trainer.init_model = _small_init_model
        ref["single"] = _train(data, str(root / "single"), max_epoch=2,
                               mesh_context=1, shard_params="")
        while not ctx.join():
            pass
    finally:
        trainer.init_model = init
        torch.set_num_threads(n)
    return torch.load(root / "ranks.pt", weights_only=False), ref, data


@pytest.mark.parametrize("case", sorted(CASES))
def test_context_step_equals_one_process(runs, case):
    got, ref, _ = runs
    (gm, gp), (wm, wp) = got[case], ref[case]
    assert len(gm) == len(wm) == STEPS
    np.testing.assert_allclose(np.array(gm), np.array(wm), rtol=TOL, atol=0,
                               err_msg=case)
    _close_params(gp, wp, TOL, case)


def test_tensor_parallel_step_equals_context_step(runs):
    got = runs[0]
    (tm, tp, _, seen), (cm, cparams) = got["tp"], got["ast"]
    np.testing.assert_allclose(np.array(tm), np.array(cm), rtol=TOL, atol=0)
    _close_params(tp, cparams, TOL, "shard-params context")
    # the blocks' fused ops saw plain tensors and parameters
    assert seen and "DTensor" not in seen


def test_tensor_parallel_checkpoint_loads_on_one_device(runs):
    got = runs[0]
    _, params, out, _ = got["tp"]
    model = init_model("AST", device="cpu", seed=0, **SMALL)
    model.load_state_dict(params, strict=True)
    with torch.no_grad():
        want = model(_eval_input())
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=TOL * float(want.abs().max()))


def test_trainer_resume_is_bit_exact(runs):
    got = runs[0]
    a = trainer.CheckpointManager(
        os.path.join(got["straight"], "latest")).restore()
    b = trainer.CheckpointManager(
        os.path.join(got["resumed"], "latest")).restore()
    assert a["epoch"] == b["epoch"] == 1 and a["loader"] == b["loader"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    sa, sb = a["opt_state"]["inner"], b["opt_state"]["inner"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    train = [r["train/loss"] for r in _records(got["straight"])
             if "train/loss" in r]
    assert train == [r["train/loss"] for r in _records(got["resumed"])
                     if "train/loss" in r]


def test_trainer_logs_the_one_process_run(runs, monkeypatch):
    got, ref, data = runs
    keys = ("train/loss",), ("test/loss", "test/PSNR", "test/SSIM")
    for ks in keys:
        test = [[r[k] for k in ks] for r in _records(got["straight"])
                if ks[0] in r]
        want = [[r[k] for k in ks] for r in _records(ref["single"])
                if ks[0] in r]
        assert len(test) == len(want) > 0 and np.isfinite(test).all()
        np.testing.assert_allclose(test, want, rtol=TOL, atol=0,
                                   err_msg=str(ks))
    # the best checkpoint on one device gives the PSNR and SSIM it logged
    run = got["straight"]
    model = _small_init_model("AST", device="cpu", img_size=SIZE)
    model.load_state_dict(restore_params(os.path.join(run, "best")),
                          strict=True)
    monkeypatch.setattr(trainer, "init_model", _small_init_model)
    cfg = Config(**{**TRAIN, "mesh_context": 1, "shard_params": ""})
    psnr, ssim = trainer.ModelTrainer(*data).evaluate(
        cfg, os.path.join(run, "best"))
    best = trainer.CheckpointManager(os.path.join(run, "best")).best_step()
    logged = [r for r in _records(run) if "test/PSNR" in r][best]
    np.testing.assert_allclose([psnr, ssim],
                               [logged["test/PSNR"], logged["test/SSIM"]],
                               rtol=1e-6)


_COMPILED = {}


def _jax_ast_apply(mesh, variables, x):
    """The JAX CP AST's ``apply``, compiled once for the module."""
    import jax

    from underwater_image_restoration_tpu.models.ast import AST as JaxAST

    if "ast" not in _COMPILED:
        _COMPILED["ast"] = jax.jit(JaxAST(**SMALL, mesh=mesh).apply).lower(
            variables, x).compile(compiler_options=FAST_COMPILE)
    return _COMPILED["ast"]


@pytest.mark.parametrize("weights", sorted(FORWARD_TOL))
def test_cp_ast_forward_matches_jax(runs, weights):
    """The port's AST forward at context 2 against the JAX AST with its
    context-parallel mesh, as ``tests/test_parallel.py`` builds it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from underwater_image_restoration_tpu.core.meshes import (
        CONTEXT_AXIS,
        make_mesh,
    )
    from underwater_image_restoration_tpu.tools.convert_checkpoint import (
        convert_state_dict,
    )

    port = _ast(weights)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    mesh = make_mesh(data=4, context=2)
    variables = jax.device_put(
        jax.tree.map(jnp.asarray, convert_state_dict("AST", sd)),
        NamedSharding(mesh, P()))
    x = _forward_input()
    xd = jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", CONTEXT_AXIS, None, None)))
    want = np.asarray(_jax_ast_apply(mesh, variables, xd)(variables, xd))
    got = runs[0]["forward"][weights]
    got = got.transpose(0, 2, 3, 1)
    tol, scaled = FORWARD_TOL[weights]
    if scaled:
        assert np.abs(want - x).max() > 0.5  # the branch is O(1)
        tol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
