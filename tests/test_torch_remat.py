"""Per-block rematerialization of the port (``ops.layers.make_remat``,
``init_model(remat=, remat_policy=)``, ``make_train_step(remat=True)``,
``--remat``/``--remat-policy``) and ``models.reinit_linear_trunc_normal``,
on the CPU in f32:

- ``make_remat(False, ...)`` is the identity; the TPU policies ``mxu`` and
  ``mxu+ew`` and unknown names raise;
- a remat model (policies ``full`` and ``dots``) against the JAX package's
  ``init_model(..., remat=True)`` with the same weights (the port's, the
  AST's and NewModel's redrawn informative as their parity tests draw
  them, carried across by ``convert_state_dict``; the JAX gradients come
  back through ``params_from_jax``): the output and every gradient of an
  ``L1withColor`` loss within the parity tests' limits (Spectral 1e-4 x
  max(1, max|ref|), AST 3e-5 x max(1, max|out|), NewModel 1e-4 of
  max|out|; gradients 1e-4 of the largest); AST at img 16,
  NewModel-Fourier at 16, NewModel-Wavelet at 32 (at 16 its bottleneck's
  DWT would take a 1 x 1 map);
- ``full``, ``dots`` and the whole-forward checkpoint of
  ``make_train_step(remat=True)`` against remat off through two Adam steps
  from one seeded DropPath generator (rate 0.1): losses, gradients and
  parameters bit-equal and the generator's state equal (the recompute
  draws the forward's decisions and leaves the generator where the forward
  left it);
- remat drops activations: the bytes of the storages the forward leaves
  alive for the backward (every op's output, watched through a
  ``TorchDispatchMode``) fall from remat off to ``dots`` (which keeps the
  weight products' outputs) to ``full`` (SpectralTransformer has no weight
  product: ``dots`` holds what ``full`` holds);
- two ranks of ``gloo`` (one spawn for the module, run while the JAX
  references compile): data parallelism (AST, DropPath 0.3), FSDP2 (the
  small SpectralTransformer of ``test_torch_parallel.py``) and context
  parallelism (AST and that SpectralTransformer over two context ranks),
  remat against remat off, two SGD steps: losses, parameters and generator
  states equal, and under context parallelism more collectives with remat
  (the checkpointed blocks' replay in the backward);
- the state_dict keys of a remat model are the plain model's, for all five
  archs; a remat model's exported program holds no checkpoint and equals
  the eager forward;
- the CLI with ``--remat --remat-policy dots`` trains one epoch and logs the
  losses of the same run without ``--remat``;
- ``reinit_linear_trunc_normal``: every Linear weight within 2 std, its
  bias zero, the convolutions untouched, the forward finite (as
  ``tests/test_models.py`` tests the JAX one), and one generator seed gives
  one draw.

The spawned ranks import this module, which imports JAX only inside the
tests.
"""
import gc
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from test_torch_parallel import SPECTRAL, _free_port
from underwater_image_restoration_torch.cli.main import main
from underwater_image_restoration_torch.core import meshes
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import (
    get_names,
    init_model,
    reinit_linear_trunc_normal,
)
from underwater_image_restoration_torch.ops import make_remat
from underwater_image_restoration_torch.parallel import context
from underwater_image_restoration_torch.tools.export_model import (
    ServingForward,
    export_module,
)
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
)

SPECTRAL_CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
                    num_refinement=1)
# arch, kwargs (image side), JAX parity limits (output, gradients)
MODELS = {
    "SpectralTransformer": ("SpectralTransformer", dict(SPECTRAL_CFG), 32),
    "AST": ("AST", dict(img_size=16, embed_dim=8, win_size=4), 16),
    "NewModel-Fourier": ("NewModel", dict(img_size=16, embed_dim=8,
                                          use_dwt="Fourier"), 16),
    "NewModel-Wavelet": ("NewModel", dict(img_size=32, embed_dim=8,
                                          use_dwt="Wavelet"), 32),
}
OUT_TOL = {"SpectralTransformer": 1e-4, "AST": 3e-5, "NewModel-Fourier": 1e-4,
           "NewModel-Wavelet": 1e-4}
GRAD_TOL = 1e-4
POLICIES = ("full", "dots")
# the JAX functions compiled with XLA's backend optimizations off (the same
# program, a fraction of the compile time on one core)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

WORLD, BATCH, STEPS = 2, 4, 2
PAR_AST = dict(img_size=32, embed_dim=8)
# arch, kwargs, image side, context ranks, FSDP2
PAR_CASES = {
    "data": ("AST", dict(PAR_AST, drop_path_rate=0.3), 32, 1, False),
    "fsdp": ("SpectralTransformer", dict(SPECTRAL), 16, 1, True),
    "context": ("AST", dict(PAR_AST), 32, 2, False),
    "context_spectral": ("SpectralTransformer", dict(SPECTRAL), 32, 2,
                         False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the transform

def test_remat_off_is_the_identity():
    for policy in (None, "full", "dots", "mxu", "bogus"):
        assert make_remat(False, policy)(torch.sin) is torch.sin


@pytest.mark.parametrize("policy,match", [
    ("mxu", "TPU-measured negatives"), ("mxu+ew", "TPU-measured negatives"),
    ("bogus", "Unknown remat policy"), ("", "Unknown remat policy")])
def test_unported_and_unknown_policies_raise(policy, match):
    with pytest.raises(ValueError, match=match):
        make_remat(True, policy)
    with pytest.raises(ValueError, match=match):
        init_model("AST", device="cpu", img_size=16, embed_dim=8,
                   remat=True, remat_policy=policy)


# ---- the two ranks (started first: they run while the JAX references
# compile)

def _par_steps(case, dp, remat):
    """STEPS SGD steps of ``case`` on the rank's rows (its band under
    context parallelism): (losses, full parameters, generator state, the
    collectives made)."""
    arch, kw, size, _, shard = PAR_CASES[case]
    context.collectives.clear()
    model = init_model(arch, device="cpu", seed=3, remat=remat,
                       cp=dp.cp if dp.cp.size > 1 else None, **kw)
    if shard:
        meshes.shard_model(model, dp)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    gen = torch.Generator().manual_seed(7)
    step = make_train_step(model, LossFunction("L1withColor"), opt,
                           generator=gen, parallel=dp)
    rows = dp.rows(BATCH)
    losses = [float(step(raw[rows], ref[rows])["loss"])
              for raw, ref in (synthetic_pair_batch(BATCH, size, seed=10 + s)
                               for s in range(STEPS))]
    if shard:
        params = meshes.full_state(model, opt)[0]
    else:
        params = {n: p.detach().clone() for n, p in model.state_dict().items()}
    return losses, params, gen.get_state(), sum(context.collectives.values())


def _worker(rank, port, out):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    res = {}
    for case, (_, _, _, ctx, _) in PAR_CASES.items():
        dp = meshes.init_data_parallel(backend="gloo", device="cpu",
                                       mesh_context=ctx)
        res[case] = [_par_steps(case, dp, remat) for remat in (False, True)]
    if dp.is_main:
        torch.save(res, out)
    meshes.close_data_parallel(dp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """A function giving the two ranks' results (waiting for them); the
    ranks start with the fixture."""
    out = tmp_path_factory.mktemp("remat_ranks") / "ranks.pt"
    ctx = mp.spawn(_worker, args=(_free_port(), str(out)), nprocs=WORLD,
                   join=False)
    done = {}

    def result():
        if not done:
            while not ctx.join():
                pass
            done["res"] = torch.load(out, weights_only=False)
        return done["res"]

    yield result
    result()  # no rank outlives the module


# ---- against the JAX package's remat models

def _no_droppath(arch, kw):
    return kw if arch == "SpectralTransformer" else dict(kw,
                                                         drop_path_rate=0.0)


_JAX = {}


def _jax_reference(key):
    """(port weights, x, y, JAX remat model's output, its gradients as the
    port's names) for ``MODELS[key]``, computed once."""
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp

    from underwater_image_restoration_tpu import models as jax_models
    from underwater_image_restoration_tpu.losses import (
        LossFunction as JaxLossFunction,
    )
    from underwater_image_restoration_tpu.tools.convert_checkpoint import (
        convert_state_dict,
    )
    from underwater_image_restoration_torch.tools.convert import (
        flatten,
        params_from_jax,
    )

    arch, kw, s = MODELS[key]
    rng = np.random.default_rng(9)
    x, y = (rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
            for _ in range(2))
    port = init_model(arch, device="cpu", seed=7, **_no_droppath(arch, kw))
    if arch == "AST":
        from test_torch_ast import _informative

        port = _informative(port, 8)
    elif arch == "NewModel":
        from test_torch_new_model import _informative

        port = _informative(port, 8)
    weights = {k: v.clone() for k, v in port.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_state_dict(
        arch, {k: v.numpy() for k, v in weights.items()}))
    jmodel = jax_models.init_model(arch, remat=True,
                                   **_no_droppath(arch, kw))
    jloss = JaxLossFunction("L1withColor")

    def loss(p):
        out = jmodel.apply(p, jnp.asarray(x))
        return jloss(out, jnp.asarray(y)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        params).compile(compiler_options=FAST_COMPILE)(params)
    _JAX[key] = (weights, x, y, np.asarray(out),
                 params_from_jax(flatten(grads["params"])))
    return _JAX[key]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("key", list(MODELS))
def test_remat_model_matches_jax_remat(ranks, key, policy):
    weights, x, y, want, grads = _jax_reference(key)
    arch, kw, _ = MODELS[key]
    port = init_model(arch, device="cpu", remat=True, remat_policy=policy,
                      **_no_droppath(arch, kw)).train()
    port.load_state_dict(weights, strict=True)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    LossFunction("L1withColor")(out, torch.from_numpy(y).permute(
        0, 3, 1, 2)).backward()
    got = out.detach().permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    if key != "NewModel-Fourier" and key != "NewModel-Wavelet":
        scale = max(1.0, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL[key] * scale)
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(grads)
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        if named[name].grad is None:
            # the Fourier encoders' dead norm2 (test_torch_new_model.py)
            assert not g.any(), name
            continue
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL * top, rtol=0,
                                   err_msg=name)


# ---- remat against remat off in the port

def _steps(key, remat, policy=None, step_remat=False):
    """Two Adam steps at DropPath rate 0.1 from one seeded generator:
    (losses, gradients, parameters, generator state)."""
    arch, kw, s = MODELS[key]
    if arch != "SpectralTransformer":
        kw = dict(kw, drop_path_rate=0.1)
    model = init_model(arch, device="cpu", seed=1, remat=remat,
                       remat_policy=policy, **kw)
    gen = torch.Generator().manual_seed(5)
    step = make_train_step(model, LossFunction("L1withColor"),
                           get_optimizer("adam", model.parameters(), 3e-4),
                           generator=gen, remat=step_remat)
    losses = [float(step(*synthetic_pair_batch(2, s, seed=i))["loss"])
              for i in range(2)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, grads, params, gen.get_state()


@pytest.mark.parametrize("how", ["full", "dots", "step"])
@pytest.mark.parametrize("key", list(MODELS))
def test_remat_is_bit_equal_to_remat_off(key, how):
    want = _steps(key, False)
    got = (_steps(key, False, step_remat=True) if how == "step"
           else _steps(key, True, how))
    assert got[0] == want[0]
    for i in (1, 2):
        assert sorted(got[i]) == sorted(want[i])
        for name in want[i]:
            assert torch.equal(got[i][name], want[i][name]), name
    assert torch.equal(got[3], want[3])


class _Alive(TorchDispatchMode):
    """Watches the storage of every op's output."""

    def __init__(self):
        super().__init__()
        self.storages = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages.append((StorageWeakRef(st), st.nbytes()))
        return out

    def alive_bytes(self):
        """Bytes of the watched storages still alive (each once)."""
        gc.collect()
        return sum({ref.cdata: n for ref, n in self.storages
                    if not ref.expired()}.values())


def _held_bytes(key, remat, policy):
    arch, kw, s = MODELS[key]
    model = init_model(arch, device="cpu", seed=1, remat=remat,
                       remat_policy=policy, **kw).train()
    x = torch.rand(2, 3, s, s, generator=torch.Generator().manual_seed(0))
    extra = ({} if arch == "SpectralTransformer"
             else {"generator": torch.Generator().manual_seed(1)})
    mode = _Alive()
    with mode:
        out = model(x * 2 - 1, **extra)
    held = mode.alive_bytes()
    out.square().mean().backward()
    assert all(p.grad is not None for n, p in model.named_parameters()
               if "q1X1_1" not in n and ".norm2." not in n), key
    return held


@pytest.mark.parametrize("key", list(MODELS))
def test_remat_drops_activations(key):
    none, dots, full = (_held_bytes(key, r, p) for r, p in
                        ((False, None), (True, "dots"), (True, "full")))
    if key == "SpectralTransformer":
        # no weight product: its 1x1s are convolutions, which both
        # policies recompute
        assert none > dots == full, (none, dots, full)
    else:
        assert none > dots > full, (none, dots, full)


@pytest.mark.parametrize("case", list(PAR_CASES))
def test_parallel_remat_equals_remat_off(ranks, case):
    """Equal results; under context parallelism the checkpointed blocks'
    collectives run again in the backward (and count again)."""
    (loss0, params0, gen0, coll0), (loss1, params1, gen1, coll1) = \
        ranks()[case]
    assert loss1 == loss0
    assert sorted(params1) == sorted(params0)
    for name in params0:
        assert torch.equal(params1[name], params0[name]), (case, name)
    assert torch.equal(gen1, gen0)
    if PAR_CASES[case][3] > 1:
        assert coll1 > coll0 > 0, (coll0, coll1)


# ---- weights, export, the CLI

def test_remat_keeps_the_parameter_names():
    for name in get_names():
        kw = (dict(SPECTRAL) if name == "SpectralTransformer"
              else dict(img_size=32, embed_dim=8))
        plain = init_model(name, device="cpu", **kw).state_dict()
        rem = init_model(name, device="cpu", remat=True,
                         remat_policy="dots", **kw).state_dict()
        assert list(rem) == list(plain), name
        assert all(torch.equal(rem[k], plain[k]) for k in plain), name


def test_exported_program_holds_no_checkpoint():
    model = init_model("SpectralTransformer", device="cpu", remat=True,
                       **SPECTRAL)
    program = export_module(model, 16, batch=2)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert not [t for t in targets if "checkpoint" in t]
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ServingForward(model)(x * 2 - 1)
    assert torch.equal(program.module()(x * 2 - 1), want)


def _pairs(root):
    for split, n, seed in (("train", 4, 0), ("test", 2, 1)):
        raw, ref = synthetic_pair_batch(n, 16, seed=seed)
        for sub, arr in (("a", raw), ("b", ref)):
            d = root / "data" / split / sub
            d.mkdir(parents=True)
            for i, img in enumerate(arr):
                Image.fromarray(img).save(d / f"{i}.png")
    return ["--train-raw", "data/train/a", "--train-ref", "data/train/b",
            "--test-raw", "data/test/a", "--test-ref", "data/test/b"]


def test_cli_remat_dots_logs_the_run_without_remat(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--use-cpu", "--image-size", "16", "--train-batch-size", "2",
              "--test-batch-size", "2", "--use-wandb", "--lossf",
              "L1withColor", "--compute-dtype", "float32", "-j", "1",
              "--watch-freq", "0", "--max-epoch", "1"] + _pairs(tmp_path)
    records = {}
    for flags in ([], ["--remat", "--remat-policy", "dots"]):
        main(common + flags + ["--checkpoint-dir", f"ck{len(flags)}"])
        (run,) = list((tmp_path / f"ck{len(flags)}").iterdir())
        records[len(flags)] = [
            {k: v for k, v in json.loads(line).items()
             if k in ("train/loss", "test/loss", "test/PSNR", "test/SSIM")}
            for line in open(run / "metrics.jsonl")]
    assert any("train/loss" in r for r in records[0])
    assert records[3] == records[0]


# ---- the trunc-normal re-init

def test_reinit_linear_trunc_normal():
    model = init_model("AST", device="cpu", img_size=16, embed_dim=8,
                       win_size=4)
    before = {n: p.clone() for n, p in model.state_dict().items()}
    assert reinit_linear_trunc_normal(
        model, torch.Generator().manual_seed(1)) is model
    linears = {n for n, m in model.named_modules()
               if isinstance(m, torch.nn.Linear)}
    assert len(linears) > 10
    for name, p in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        if owner in linears and leaf == "weight":
            assert float(p.abs().max()) <= 0.04  # 2 std
            assert float(p.std()) > 0.005 and not torch.equal(p, before[name])
        elif owner in linears and leaf == "bias":
            assert not p.any()
        else:
            assert torch.equal(p, before[name]), name
    with torch.no_grad():
        y = model(torch.rand(1, 3, 16, 16) * 2 - 1)
    assert bool(torch.isfinite(y).all())


def test_reinit_same_generator_same_draw():
    def draw(seed):
        m = init_model("NewModel", device="cpu", img_size=16, embed_dim=8)
        reinit_linear_trunc_normal(m, torch.Generator().manual_seed(seed))
        return m.state_dict()

    a, b, c = draw(3), draw(3), draw(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
