"""Context parallelism of SpectralTransformer, on the CPU in f32 over two
ranks of ``gloo`` with ``mesh_context=2`` (one spawn of two processes for
the module; the one-process references run here meanwhile).  The model is
small but at the full widths: channels 16/32/64/128, heads 1/2/4/8, one
block a stage and one refinement block, 32x32 images, so its bands are
16/8/4/2 rows and the deepest level sits at the 2-row edge of LN+MDTA's
halo.

- (a) ``ln_mdta_rows`` and ``ln_gdfn_rows`` (the plain versions, and the
  wrappers' CPU route) on each rank's band, gathered, equal
  ``ln_mdta_plain`` / ``ln_gdfn_plain`` of the whole map: the output and
  every gradient (dx through the halo's adjoint, the weights summed over
  the ranks, dtemp among them counted once): the output and dx within
  1e-6 of max|ref|, the weights' within WEIGHT_TOL (5e-6) of theirs, at
  the first level's shape and at the deepest level's (bands of 2 rows);
  the same inputs in float64 on both sides hold every one within 1e-6;
- (b) the context-parallel train step (two SGD steps, momentum 0.9, global
  batch 4) equals the one-process step: losses and grad norms within 1e-6
  relative, every parameter within 1e-6 of max|ref|; so does the step at
  24x24 (MIXED), where the first three levels run on bands (12, 6 and 3
  rows) and the deepest (3 rows) runs whole on each rank, gathered before
  its DownSample and sliced after its UpS; the step at ``k_steps=2`` (one
  call of the two steps; one after another, as on the card, where context
  ranks take the ``stepwise`` route) equals the two single steps bit for
  bit;
- (c) the gathered context-parallel forward equals the JAX package's
  SpectralTransformer over ``make_mesh(data=4, context=2)`` (the JAX
  variables from the port's state_dict by the JAX package's converter,
  which ``tools.convert.params_from_jax`` maps back exactly) within 1e-4 x
  max(1, max|ref|), the tolerance of
  ``tests/test_torch_spectral_transformer.py``;
- (d) ``ModelTrainer`` with ``mesh_context=2, shard_params='context'``:
  two epochs log the one-process run's loss, PSNR and SSIM within 1e-6
  relative, and the single-device ``evaluate`` of its best checkpoint gives
  what it logged.

The spawned ranks import this module, which imports JAX only inside the
tests.
"""
import itertools
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_context_models import FAST_COMPILE, _write_pairs
from test_torch_parallel import _close_params, _free_port, _records
from underwater_image_restoration_torch.core import meshes
from underwater_image_restoration_torch.core.config import Config
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops.fused_gdfn import (
    ln_gdfn_plain,
    ln_gdfn_rows,
)
from underwater_image_restoration_torch.ops.fused_mdta import (
    ln_mdta_plain,
    ln_mdta_rows,
)
from underwater_image_restoration_torch.parallel import gather_replicated
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
    restore_params,
)
from underwater_image_restoration_torch.train import trainer

WORLD, BATCH, STEPS, SIZE = 2, 4, 2, 32
# a side whose deepest level the two ranks cannot band: a mixed layout
MIXED = 24
TOL = 1e-6
# the band ops' weight gradients, of max|ref|: a taps gradient sums the
# products of about 2000 pixels that cancel to a few percent of their
# terms, in another order on two bands than on the whole map (f32 roundoff
# of up to 2.2e-6 at the first level; in float64 the two agree to
# rounding: test_band_op_equals_whole_map_float64)
WEIGHT_TOL = 5e-6
DTYPES = {"float32": np.float32, "float64": np.float64}
# the CP steps' last gradients, of the largest reference gradient over the
# model.  The deepest levels' gradients are 1e-6 to 1e-4 of it at this
# init, so the parameters after two SGD steps at lr 1e-2 cannot show them.
# f32 sums over the bands in another order read 2.9e-6 (32x32) and 1.5e-6
# (MIXED); gather_rows' adjoint without its sum over the ranks reads
# 4.5e-5 at MIXED
STEP_GRAD_TOL = 5e-6
SMALL = dict(channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
             num_blocks=(1, 1, 1, 1), num_refinement=1)
# the band ops' shapes: the first level (C, heads, side) and the deepest
OPS = {"level0": (16, 1, 32), "level3": (128, 8, 4)}
TRAIN = dict(image_size=SIZE, train_batch_size=4, test_batch_size=2,
             compute_dtype="float32", use_cpu=True, mesh_context=WORLD,
             shard_params="context", lossf="L1withColor", optim="sgd",
             lr=1e-2, workers=1, print_freq=100, use_wandb=False,
             watch_freq=0, arch="SpectralTransformer")


def _op_inputs(c, heads, side, dtype="float32"):
    """(x, dy, the LN+MDTA weights, the LN+GDFN weights) from a seed, in
    ``dtype``, each weight O(1) in its branch and the temperatures away
    from 1."""
    rng = np.random.default_rng(c + side)
    hid = int(c * 2.66)
    dt = DTYPES[dtype]

    def n(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(dt) * std)

    x, dy = n(2, c, side, side), n(2, c, side, side)
    mdta = [1 + n(c, std=0.1), n(c, std=0.1), n(c, 3 * c, std=c ** -0.5),
            n(3, 3, 3 * c, std=0.3),
            torch.from_numpy(rng.uniform(0.5, 2.0, (1, heads, 1, 1)).astype(
                dt)),
            n(c, c, std=c ** -0.5), n(c, 2 * c, std=c ** -0.5),
            n(3, 3, 2 * c, std=0.3), n(c, c, std=c ** -0.5)]
    gdfn = [1 + n(c, std=0.1), n(c, std=0.1), n(c, 2 * hid, std=c ** -0.5),
            n(3, 3, 2 * hid, std=0.3), n(hid, c, std=hid ** -0.5)]
    return x, dy, mdta, gdfn


def _op_grads(fn, x, dy, ws):
    """(y, [dx, *dweights]) of sum(fn(x, *ws) * dy) by autograd."""
    ins = [t.clone().requires_grad_() for t in (x, *ws)]
    y = fn(*ins)
    return y.detach(), list(torch.autograd.grad(y, ins, dy))


def _band_ops(cp):
    """(a) on this rank's band: {(shape, op, route, dtype): (y, grads)}."""
    out = {}
    for (name, (c, heads, side)), dtype in itertools.product(OPS.items(),
                                                             DTYPES):
        x, dy, mdta, gdfn = _op_inputs(c, heads, side, dtype)
        band = cp.band(side)
        xb, dyb = x[:, :, band], dy[:, :, band]
        for route, kern in (("plain", False), ("wrapper", True)):
            out[name, "mdta", route, dtype] = _op_grads(
                lambda t, *w: ln_mdta_rows(t, *w, heads, cp=cp,
                                           use_kernels=kern), xb, dyb, mdta)
            out[name, "gdfn", route, dtype] = _op_grads(
                lambda t, *w: ln_gdfn_rows(t, *w, cp=cp, use_kernels=kern),
                xb, dyb, gdfn)
    return out


def _batches(size):
    return [synthetic_pair_batch(BATCH, size, seed=10 + s)
            for s in range(STEPS)]


def run_steps(dp=None, size=SIZE, k_steps=1):
    """STEPS SGD steps on the global batches of ``size`` images (the rank's
    band under ``dp``), single steps or one call of ``k_steps`` = STEPS:
    ([(loss, grad_norm)], the parameters, the last step's gradients)."""
    model = init_model("SpectralTransformer", device="cpu", seed=3,
                       cp=None if dp is None else dp.cp, **SMALL)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    step = make_train_step(model, LossFunction("L1withColor"), opt,
                           parallel=dp, k_steps=k_steps)
    batches = _batches(size)
    if k_steps == 1:
        metrics = [tuple(float(v) for v in step(raw, ref).values())
                   for raw, ref in batches]
    else:
        out = step(np.stack([r for r, _ in batches]),
                   np.stack([f for _, f in batches]))
        metrics = list(zip(*(v.tolist() for v in out.values())))
    return metrics, {n: p.detach().clone()
                     for n, p in model.state_dict().items()}, {
        n: p.grad.clone() for n, p in model.named_parameters()}


def _forward_input():
    return np.random.default_rng(1).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)
                                            ).astype(np.float32)


def _small_init_model(arch, **kw):
    return init_model(arch, **{**kw, **SMALL})


def _train(data, ckpt, **kw):
    trainer.ModelTrainer(*data).train(
        Config(checkpoint_dir=ckpt, **TRAIN).replace(**kw))
    return os.path.join(ckpt, os.listdir(ckpt)[0])


def _worker(rank, port, out_dir, data):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dp = meshes.init_data_parallel(backend="gloo", device="cpu",
                                   mesh_context=WORLD)
    res = {"ops": _band_ops(dp.cp), "step": run_steps(dp),
           "step_mixed": run_steps(dp, MIXED),
           "step_k": run_steps(dp, k_steps=STEPS)}
    model = init_model("SpectralTransformer", device="cpu", seed=3,
                       cp=dp.cp, **SMALL)
    res["levels_mixed"] = model.levels_banded(MIXED, MIXED)
    x = torch.from_numpy(_forward_input()).permute(0, 3, 1, 2)
    with torch.no_grad():
        res["forward"] = gather_replicated(
            model(x[:, :, dp.cp.band(SIZE)]), dp.cp, 2).numpy()
    res["state"] = {k: v.numpy() for k, v in model.state_dict().items()}
    trainer.init_model = _small_init_model
    res["run"] = _train(data, str(pathlib.Path(out_dir) / "cp"),
                        max_epoch=2)
    torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    meshes.close_data_parallel(dp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, the one-process references (computed while
    the ranks run) and the trainer's data."""
    root = tmp_path_factory.mktemp("context_spectral")
    data = _write_pairs(root / "data")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = mp.spawn(_worker, args=(_free_port(), str(root), data),
                   nprocs=WORLD, join=False)
    init = trainer.init_model
    try:
        ref = {"step": run_steps(), "step_mixed": run_steps(size=MIXED)}
        for (name, (c, heads, side)), dtype in itertools.product(
                OPS.items(), DTYPES):
            x, dy, mdta, gdfn = _op_inputs(c, heads, side, dtype)
            ref[name, "mdta", dtype] = _op_grads(
                lambda t, *w: ln_mdta_plain(t, *w, heads), x, dy, mdta)
            ref[name, "gdfn", dtype] = _op_grads(ln_gdfn_plain, x, dy,
                                                 gdfn)
        trainer.init_model = _small_init_model
        ref["run"] = _train(data, str(root / "single"), max_epoch=2,
                            mesh_context=1, shard_params="")
        while not ctx.join():
            pass
    finally:
        trainer.init_model = init
        torch.set_num_threads(n)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, ref, data


def _check_band_op(runs, shape, op, route, dtype, weight_tol):
    """The ranks' outputs and dx concatenated over the rows, their weight
    gradients summed, against the whole map's: y and dx within TOL of
    max|ref|, the weights' within ``weight_tol``."""
    ranks, ref, _ = runs
    (want_y, want_g) = ref[shape, op, dtype]
    got = [r["ops"][shape, op, route, dtype] for r in ranks]
    got_y = torch.cat([y for y, _ in got], 2)
    got_dx = torch.cat([g[0] for _, g in got], 2)
    sums = [sum(g[i] for _, g in got) for i in range(1, len(want_g))]
    assert got_y.dtype == want_y.dtype == getattr(torch, dtype)
    for what, a, b, tol in [("y", got_y, want_y, TOL),
                            ("dx", got_dx, want_g[0], TOL)] + [
            (f"dweight {i}", s, w, weight_tol) for i, (s, w) in
            enumerate(zip(sums, want_g[1:]))]:
        assert a.shape == b.shape, what
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=0, atol=tol * float(b.abs().max()),
            err_msg=f"{shape} {op} {route} {dtype} {what}")


@pytest.mark.parametrize("route", ["plain", "wrapper"])
@pytest.mark.parametrize("op", ["mdta", "gdfn"])
@pytest.mark.parametrize("shape", sorted(OPS))
def test_band_op_equals_whole_map(runs, shape, op, route):
    _check_band_op(runs, shape, op, route, "float32", WEIGHT_TOL)


@pytest.mark.parametrize("route", ["plain", "wrapper"])
@pytest.mark.parametrize("op", ["mdta", "gdfn"])
@pytest.mark.parametrize("shape", sorted(OPS))
def test_band_op_equals_whole_map_float64(runs, shape, op, route):
    """The same inputs in float64 on both sides: every gradient, the
    weights' too, within TOL; what WEIGHT_TOL allows in f32 is f32's
    rounding of sums taken in another order, not the halo."""
    _check_band_op(runs, shape, op, route, "float64", TOL)


def _check_step(got, want, what):
    """Losses and grad norms within TOL relative, every parameter within
    TOL of max|ref|, every gradient within STEP_GRAD_TOL of the largest
    reference gradient."""
    (gm, gp, gg), (wm, wp, wg) = got, want
    assert len(gm) == len(wm) == STEPS
    np.testing.assert_allclose(np.array(gm), np.array(wm), rtol=TOL, atol=0)
    _close_params(gp, wp, TOL, what)
    top = max(float(g.abs().max()) for g in wg.values())
    assert sorted(gg) == sorted(wg)
    for n in wg:
        np.testing.assert_allclose(gg[n].numpy(), wg[n].numpy(), rtol=0,
                                   atol=STEP_GRAD_TOL * top,
                                   err_msg=f"{what}: gradient of {n}")


def test_context_step_equals_one_process(runs):
    ranks, ref, _ = runs
    for r in ranks:
        _check_step(r["step"], ref["step"], "SpectralTransformer context step")


def test_context_k_steps_equal_single_steps(runs):
    """Two context ranks' ``k_steps=2`` call equals their two single steps
    bit for bit: metrics, parameters and the last gradients."""
    ranks = runs[0]
    for r in ranks:
        (km, kp, kg), (sm, sp, sg) = r["step_k"], r["step"]
        assert km == sm and len(km) == STEPS
        for n in sp:
            assert torch.equal(kp[n], sp[n]), n
        for n in sg:
            assert torch.equal(kg[n], sg[n]), n


def test_mixed_layout_step_equals_one_process(runs):
    """At MIXED the deepest level runs whole on every rank (the gather
    before down3, the slice after ups_1, and their adjoints in the
    backward), the others on bands; the step is one process's."""
    ranks, ref, _ = runs
    for r in ranks:
        assert r["levels_mixed"] == ([True, True, True, False],
                                     [True, True, True, False])
        _check_step(r["step_mixed"], ref["step_mixed"],
                    "SpectralTransformer mixed layout step")


_COMPILED = {}


def test_cp_forward_matches_jax(runs):
    """The port's forward at context 2 against the JAX SpectralTransformer
    with its context-parallel mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from underwater_image_restoration_tpu.core.meshes import (
        CONTEXT_AXIS,
        make_mesh,
    )
    from underwater_image_restoration_tpu.models import (
        init_model as jax_init_model,
    )
    from underwater_image_restoration_tpu.tools.convert_checkpoint import (
        convert_state_dict,
    )
    from underwater_image_restoration_torch.tools.convert import (
        flatten,
        params_from_jax,
    )

    ranks = runs[0]
    sd = ranks[0]["state"]
    tree = convert_state_dict("SpectralTransformer", sd)
    back = params_from_jax(flatten(tree["params"]))
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    mesh = make_mesh(data=4, context=2)
    variables = jax.device_put(jax.tree.map(jnp.asarray, tree),
                               NamedSharding(mesh, P()))
    x = _forward_input()
    xd = jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", CONTEXT_AXIS, None, None)))
    model = jax_init_model("SpectralTransformer", mesh=mesh, **SMALL)
    fn = jax.jit(model.apply).lower(variables, xd).compile(
        compiler_options=FAST_COMPILE)
    want = np.asarray(fn(variables, xd))
    for r in ranks:
        got = r["forward"].transpose(0, 2, 3, 1)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_trainer_logs_the_one_process_run(runs, monkeypatch):
    ranks, ref, data = runs
    run = ranks[0]["run"]
    for ks in (("train/loss",), ("test/loss", "test/PSNR", "test/SSIM")):
        test = [[r[k] for k in ks] for r in _records(run) if ks[0] in r]
        want = [[r[k] for k in ks] for r in _records(ref["run"])
                if ks[0] in r]
        assert len(test) == len(want) > 0 and np.isfinite(test).all()
        np.testing.assert_allclose(test, want, rtol=TOL, atol=0,
                                   err_msg=str(ks))
    # the best checkpoint on one device gives the PSNR and SSIM it logged
    model = _small_init_model("SpectralTransformer", device="cpu")
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
