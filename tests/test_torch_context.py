"""The port's context-parallel primitives (``parallel/context.py``,
``parallel/cp_ops.py``, ``ops.fused_leff.ln_leff_rows``) and the AST's
context-parallel train step, on the CPU in f32 over four ranks
of ``gloo`` (one spawn of four processes for the module; the JAX side and
the one-process references run here meanwhile).  Each rank holds its band
of the rows (and its data index's images) of a
``make_mesh(data=1, context=4)`` and a ``make_mesh(data=2, context=2)``
layout, the JAX package's ``P("data", "context")`` on the conftest's
virtual CPU devices:

- ``halo_exchange`` (up and down), ``cp_shift_roll``, ``cp_unshift_roll``
  (the JAX functions inside ``shard_map``) and ``cp_roll2d`` (through
  ``cp_ops.roll2d``): forward and gradient bit-equal to the JAX functions;
- ``cp_window_attention`` (shifted, masked), ``cp_window_attention_qkv``
  (masked, through ``cp_ops.window_attention``),
  ``ulysses_window_attention``, ``sharded_fft2`` (through ``cp_ops.fft2``)
  and ``sharded_ifft2``: forward and gradients (the band's inputs; the bias's
  and the mix's summed over the ranks) within 1e-5 of max|ref| of the JAX
  drivers over the mesh;
- the halo'd convolutions (3x3/pad 1, the AST's 4x4/stride 2/pad 1,
  depthwise), the New* encoders' (L, C)-token FFT, FDFP's real spatial
  FFTs (``cp_ops.fftn_real_spatial``) and LN+LeFF on a band
  with a halo row each side: the rank's rows of the same op on the whole
  map, forward and gradients (weights summed over the ranks) within 1e-5
  of max|ref|;
- the AST's context-parallel train step (32x32, embed 8, window 8, two SGD
  steps, momentum 0.9, global batch 4) equals the one-process step, losses
  and grad norms within 1e-6 relative and every parameter within 1e-6 of
  max|ref|: at context 4 (its levels below 8x8 and its decoders at 8x8 and
  16x16 are not viable on bands, so the gather path runs) and, with
  DropPath at 0.3, over data 2 x context 2 (each data index draws its
  images' decisions, alike on its context ranks);
- (the AST's context-parallel forward against the JAX CP model is in
  ``test_torch_context_models.py``).

The spawned ranks import this module, which imports JAX only inside the
tests.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from underwater_image_restoration_torch.core import meshes
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops.fused_leff import (
    ln_leff_plain,
    ln_leff_rows,
)
from underwater_image_restoration_torch.ops.windows import shift_window_mask
from underwater_image_restoration_torch.parallel import context as C
from underwater_image_restoration_torch.parallel import cp_ops
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
)

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
TOL = 1e-5
# the bias's and the mix vector's gradients sum every window's terms, which
# cancel (the mix's two entries are each other's negatives): the JAX
# function's f32 sum is 1.2e-5 of max|ref| from the f64 value in the masked
# qkv case, the port's (four f32 partial sums) 1.8e-7
REP_TOL = 3e-5
STEP_TOL = 1e-6
# the JAX functions compiled with XLA's backend optimizations off (the same
# program, a fraction of the compile time on one core)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
B, H, W, CH = 4, 16, 8, 8
WIN, HEADS, SHIFT, SCALE = 4, 2, 2, 0.3
N_WIN_H = H // WIN
AST_KW = dict(img_size=32, embed_dim=8)
STEP_CASES = {"ast_context4": ("1x4", dict(AST_KW)),
              "ast_droppath_2x2": ("2x2", dict(AST_KW, drop_path_rate=0.3))}
BATCH, STEPS = 4, 2


def _inputs():
    """The seeded inputs, global shapes (numpy f32)."""
    rng = np.random.default_rng(0)

    def f(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    nw = N_WIN_H * (W // WIN)
    n = WIN * WIN
    return {
        "img": f(B, H, W, CH),
        "q": f(B * nw, HEADS, n, 4), "k": f(B * nw, HEADS, n, 4),
        "v": f(B * nw, HEADS, n, 4), "bias": f(HEADS, n, n, std=0.5),
        "w": np.array([0.3, -0.4], np.float32),
        "mask": shift_window_mask(H, W, WIN, SHIFT),
        "uq": f(16, 4, n, 4), "uk": f(16, 4, n, 4), "uv": f(16, 4, n, 4),
        "ubias": f(4, n, n, std=0.5),
        "conv3": f(6, CH, 3, 3, std=0.3), "conv4": f(6, CH, 4, 4, std=0.3),
        "dw": f(CH, 1, 3, 3, std=0.3), "cb": f(6, std=0.1),
        "dwb": f(CH, std=0.1),
        "leff": [f(CH, std=0.1) + 1, f(CH, std=0.1), f(CH, 32, std=0.3),
                 f(32, std=0.1), f(3, 3, 32, std=0.3), f(32, std=0.1),
                 f(32, CH, std=0.2), f(CH, std=0.1)],
    }


def _ct(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# how a rank holds a global array: "img" (B, H, ...) batch over data, rows
# over context; "win" (B nW, ...) windows batch-major, window rows over
# context; "lead" dim 0 over context alone; "rep" whole on every rank


def _local(a, kind, d, c, nd, nc):
    a = np.asarray(a)
    if kind == "rep":
        return a
    if kind == "lead":
        m = a.shape[0] // nc
        return a[c * m:(c + 1) * m]
    if kind == "img":
        bb, hh = a.shape[0] // nd, a.shape[1] // nc
        return a[d * bb:(d + 1) * bb, c * hh:(c + 1) * hh]
    rest = a.shape[1:]
    a = a.reshape(B, -1, *rest)
    bb, ww = B // nd, a.shape[1] // nc
    return a[d * bb:(d + 1) * bb, c * ww:(c + 1) * ww].reshape(-1, *rest)


def _assemble(parts, kind, nd, nc):
    """The global array from the ranks' local ones (rank r = d nc + c)."""
    if kind == "lead":
        return np.concatenate([parts[c] for c in range(nc)])
    rows = []
    for d in range(nd):
        band = [parts[d * nc + c] for c in range(nc)]
        if kind == "img":
            rows.append(np.concatenate(band, 1))
        else:
            rest = band[0].shape[1:]
            rows.append(np.concatenate(
                [b.reshape(B // nd, -1, *rest) for b in band], 1))
    out = np.concatenate(rows, 0)
    return out if kind == "img" else out.reshape(-1, *out.shape[2:])


def _rep_sum(parts, nd, nc, over_data):
    """A replicated input's gradient: summed over the ranks (over one data
    index's context ranks where the data dimension replicates the
    computation)."""
    ranks = range(nd * nc) if over_data else range(nc)
    return sum(np.asarray(parts[r], np.float64) for r in ranks)


# (name, inputs as (key, kind, differentiable), output kind, complex out,
#  data-sharded, tolerance)
PRIMS = {
    "halo_up": ((("img", "img", True),), "img", False, True, 0.0),
    "halo_down": ((("img", "img", True),), "img", False, True, 0.0),
    "shift_roll": ((("img", "img", True),), "img", False, True, 0.0),
    "unshift_roll": ((("img", "img", True),), "img", False, True, 0.0),
    "roll2d": ((("img", "img", True),), "img", False, True, 0.0),
    "window_attention": ((("img", "img", True), ("bias", "rep", True),
                          ("w", "rep", True)), "img", False, True, TOL),
    "window_attention_qkv": ((("q", "win", True), ("k", "win", True),
                              ("v", "win", True), ("bias", "rep", True),
                              ("w", "rep", True)), "win", False, True, TOL),
    "ulysses": ((("uq", "lead", True), ("uk", "lead", True),
                 ("uv", "lead", True), ("ubias", "rep", True),
                 ("w", "rep", True)), "lead", False, False, TOL),
    "fft2": ((("img", "img", True),), "img", True, True, TOL),
    "ifft2": ((("img", "img", True),), "img", True, True, TOL),
}


def _port_prim(name, args, cp):
    """The port's primitive on the rank's local arguments."""
    if name == "halo_up":
        return C.halo_exchange(args[0], SHIFT, cp, "up")
    if name == "halo_down":
        return C.halo_exchange(args[0], SHIFT, cp, "down")
    if name == "shift_roll":
        return C.cp_shift_roll(args[0], 3, cp)
    if name == "unshift_roll":
        return C.cp_unshift_roll(args[0], 3, cp)
    if name == "roll2d":
        return cp_ops.roll2d(args[0], -3, 2, cp)
    mask = torch.from_numpy(_inputs()["mask"])
    if name == "window_attention":
        x, bias, w = args
        return C.cp_window_attention(x, bias, cp=cp, win_size=WIN,
                                     num_heads=HEADS, scale=SCALE,
                                     sparse_w=w, shift=SHIFT, mask=mask)
    if name == "window_attention_qkv":  # through the model's dispatcher
        q, k, v, bias, w = args
        return cp_ops.window_attention(q, k, v, bias, scale=SCALE,
                                       sparse_w=w, mask=mask, cp=cp,
                                       n_win_h=N_WIN_H)
    if name == "ulysses":
        q, k, v, bias, w = args
        return C.ulysses_window_attention(q, k, v, bias, cp=cp, scale=SCALE,
                                          sparse_w=w)
    if name == "fft2":
        return cp_ops.fft2(args[0], cp)
    return C.sharded_ifft2(args[0], cp)


def _functional(out, ct_re, ct_im=None):
    if out.is_complex():
        return (out.real * ct_re).sum() + (out.imag * ct_im).sum()
    return (out * ct_re).sum()


def _out_shape(name, nc):
    if name in ("halo_up", "halo_down"):
        return (B, SHIFT * nc, W, CH)
    ins = _inputs()
    return {"window_attention_qkv": ins["q"].shape,
            "ulysses": ins["uq"].shape}.get(name, ins["img"].shape)


def _run_prims(dp, mesh_name):
    nd, nc = MESHES[mesh_name]
    d, c = dp.rank, dp.cp.index
    ins = _inputs()
    res = {}
    for name, (spec, okind, cx, _, _) in PRIMS.items():
        args = [torch.from_numpy(np.ascontiguousarray(
            _local(ins[key], kind, d, c, nd, nc))).requires_grad_(diff)
            for key, kind, diff in spec]
        out = _port_prim(name, args, dp.cp)
        shape = _out_shape(name, nc)
        cts = [torch.from_numpy(np.ascontiguousarray(
            _local(_ct(shape, s), okind, d, c, nd, nc))) for s in (1, 2)]
        _functional(out, *cts[:1 + cx]).backward()
        res[name] = (out.detach().numpy(),
                     [a.grad.numpy() for a in args])
    return res


# the port-only cases: a band's op against the same op on the whole map
def _ref_ops():
    ins = _inputs()
    t = {k: torch.from_numpy(v) for k, v in ins.items()
         if isinstance(v, np.ndarray)}
    leff = [torch.from_numpy(a) for a in ins["leff"]]
    return {
        "conv3x3": (lambda x, cp: cp_ops.conv2d(x.permute(0, 3, 1, 2),
                                                t["conv3"], t["cb"], 1, 1,
                                                1, cp).permute(0, 2, 3, 1)),
        "conv4x4_stride2": (lambda x, cp: cp_ops.conv2d(
            x.permute(0, 3, 1, 2), t["conv4"], t["cb"], 2, 1, 1,
            cp).permute(0, 2, 3, 1)),
        "depthwise3x3": (lambda x, cp: cp_ops.conv2d(
            x.permute(0, 3, 1, 2), t["dw"], t["dwb"], 1, 1, CH,
            cp).permute(0, 2, 3, 1)),
        "token_fft": (lambda x, cp: cp_ops.fftn_real_tokens(
            x.reshape(x.shape[0], -1, CH), cp=cp).reshape(x.shape)),
        "token_ifft": (lambda x, cp: cp_ops.fftn_real_tokens(
            x.reshape(x.shape[0], -1, CH), inverse=True, cp=cp).reshape(
                x.shape)),
        "spatial_fft": (lambda x, cp: cp_ops.fftn_real_spatial(x, cp)),
        "spatial_ifft": (lambda x, cp: cp_ops.ifftn_real_spatial(x, cp)),
        "ln_leff_residual": (lambda x, cp: ln_leff_rows(
            x, *leff, cp=cp, residual=True, fn=ln_leff_plain)),
        "ln_leff_branch": (lambda x, cp: ln_leff_rows(
            x, *leff, cp=cp, residual=False, fn=ln_leff_plain)),
    }, [t["conv3"], t["conv4"], t["dw"], t["cb"], t["dwb"], *leff]


def _op_grads(name, x, cp, ct):
    """(output, dx, the weights' gradients) of a port-only case."""
    ops, weights = _ref_ops()
    for p in weights:
        p.requires_grad_()
    x = x.clone().requires_grad_()
    out = ops[name](x, cp)
    (out * ct).sum().backward()
    return (out.detach().numpy(), x.grad.numpy(),
            [np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.numpy() for p in weights])


def _run_ops(dp, mesh_name):
    nd, nc = MESHES[mesh_name]
    d, c = dp.rank, dp.cp.index
    img = _inputs()["img"]
    out = {}
    for name in _ref_ops()[0]:
        whole = _op_grads(name, torch.from_numpy(img), None,
                          torch.ones(1))[0]
        ct = _local(_ct(whole.shape, 3), "img", d, c, nd, nc)
        out[name] = _op_grads(name, torch.from_numpy(np.ascontiguousarray(
            _local(img, "img", d, c, nd, nc))), dp.cp,
            torch.from_numpy(np.ascontiguousarray(ct)))
    return out


# ---------------------------------------------------------------------------
# the AST


def run_steps(case, dp=None):
    """STEPS SGD steps of the AST case on the global batches (the rank's
    data index's rows and its band under ``dp``): ([(loss, grad_norm)],
    the parameters)."""
    _, kw = STEP_CASES[case]
    model = init_model("AST", device="cpu", seed=3,
                       cp=None if dp is None else dp.cp, **kw)
    opt = get_optimizer("sgd", model.parameters(), 1e-2, momentum=0.9)
    step = make_train_step(model, LossFunction("L1withColor"), opt,
                           generator=torch.Generator().manual_seed(7),
                           parallel=dp)
    rows = slice(None) if dp is None else dp.rows(BATCH)
    metrics = [tuple(float(v) for v in step(raw[rows], ref[rows]).values())
               for raw, ref in (synthetic_pair_batch(BATCH, 32, seed=10 + s)
                                for s in range(STEPS))]
    return metrics, {n: p.detach().clone()
                     for n, p in model.state_dict().items()}


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    res = {}
    for mesh_name, (nd, nc) in MESHES.items():
        dp = meshes.init_data_parallel(backend="gloo", device="cpu",
                                       mesh_context=nc)
        assert (dp.world, dp.cp.size, dp.rank, dp.cp.index) == (
            nd, nc, rank // nc, rank % nc)
        res[mesh_name] = {"prims": _run_prims(dp, mesh_name),
                          "ops": _run_ops(dp, mesh_name)}
        for case, (where, _) in STEP_CASES.items():
            if where == mesh_name:
                res[case] = run_steps(case, dp)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    meshes.close_data_parallel(dp)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results and the one-process step references
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("context")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = mp.spawn(_worker, args=(_free_port(), str(out)), nprocs=WORLD,
                   join=False)
    try:
        ref = {case: run_steps(case) for case in STEP_CASES}
        while not ctx.join():
            pass
    finally:
        torch.set_num_threads(n)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)], ref


def _jax_mesh(mesh_name):
    from underwater_image_restoration_tpu.core.meshes import make_mesh

    nd, nc = MESHES[mesh_name]
    return make_mesh(data=nd, context=nc)


def _jax_prim(name, mesh):
    """The JAX function of a primitive over ``mesh``, on global arrays."""
    import jax
    from jax.sharding import PartitionSpec as P

    from underwater_image_restoration_tpu.parallel import context as J

    img = P("data", "context", None, None)

    def shard(body):
        return jax.shard_map(body, mesh=mesh, in_specs=img, out_specs=img)

    mask = _inputs()["mask"]
    return {
        "halo_up": shard(lambda x: J.halo_exchange(x, SHIFT, "context",
                                                   "up")),
        "halo_down": shard(lambda x: J.halo_exchange(x, SHIFT, "context",
                                                     "down")),
        "shift_roll": shard(lambda x: J.cp_shift_roll(x, 3)),
        "unshift_roll": shard(lambda x: J.cp_unshift_roll(x, 3)),
        "roll2d": lambda x: J.cp_roll2d(x, -3, 2, mesh),
        "window_attention": lambda x, b, w: J.cp_window_attention(
            x, b, mesh=mesh, win_size=WIN, num_heads=HEADS, scale=SCALE,
            sparse_w=w, shift=SHIFT, mask=mask),
        "window_attention_qkv": lambda q, k, v, b, w:
            J.cp_window_attention_qkv(q, k, v, b, scale=SCALE, mesh=mesh,
                                      batch=B, sparse_w=w, mask=mask),
        "ulysses": lambda q, k, v, b, w: J.ulysses_window_attention(
            q, k, v, b, mesh=mesh, scale=SCALE, sparse_w=w),
        "fft2": lambda x: J.sharded_fft2(x, mesh),
        "ifft2": lambda x: J.sharded_ifft2(x, mesh),
    }[name]


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1e-30, float(np.abs(want).max())),
        err_msg=what)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(PRIMS))
def test_primitive_matches_jax(ranks, name, mesh_name):
    import jax
    import jax.numpy as jnp

    nd, nc = MESHES[mesh_name]
    spec, okind, cx, data_sharded, tol = PRIMS[name]
    ins = _inputs()
    fn = _jax_prim(name, _jax_mesh(mesh_name))
    args = [jnp.asarray(ins[key]) for key, _, _ in spec]
    cts = [jnp.asarray(_ct(_out_shape(name, nc), s)) for s in (1, 2)]

    def functional(*a):
        out = fn(*a)
        if cx:
            return jnp.sum(jnp.real(out) * cts[0] + jnp.imag(out) * cts[1])
        return jnp.sum(out * cts[0])

    def both(*a):
        return fn(*a), jax.grad(functional, argnums=tuple(range(len(a))))(*a)

    want, wgrads = jax.jit(both).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    want = np.asarray(want)
    parts = [r[mesh_name]["prims"][name] for r in ranks[0]]
    got = _assemble([p[0] for p in parts], okind, nd, nc)
    _close(got, want, tol, f"{name} forward")
    for i, (key, kind, _) in enumerate(spec):
        gi = [p[1][i] for p in parts]
        g = (_rep_sum(gi, nd, nc, data_sharded) if kind == "rep"
             else _assemble(gi, kind, nd, nc))
        _close(g, np.asarray(wgrads[i]), REP_TOL if kind == "rep" and tol
               else tol, f"{name} d{key}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["conv3x3", "conv4x4_stride2",
                                  "depthwise3x3", "token_fft", "token_ifft",
                                  "spatial_fft", "spatial_ifft",
                                  "ln_leff_residual", "ln_leff_branch"])
def test_band_op_matches_whole_map(ranks, name, mesh_name):
    nd, nc = MESHES[mesh_name]
    img = torch.from_numpy(_inputs()["img"])
    want = _op_grads(name, img, None, torch.ones(1))[0]
    want, dx, dw = _op_grads(name, img, None, torch.from_numpy(
        _ct(want.shape, 3)))
    parts = [r[mesh_name]["ops"][name] for r in ranks[0]]
    _close(_assemble([p[0] for p in parts], "img", nd, nc), want, TOL,
           f"{name} forward")
    _close(_assemble([p[1] for p in parts], "img", nd, nc), dx, TOL,
           f"{name} dx")
    for i, w in enumerate(dw):
        if np.abs(w).max() > 0:
            _close(_rep_sum([p[2][i] for p in parts], nd, nc, True), w, TOL,
                   f"{name} dweight {i}")


def _close_params(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    scale = max(float(w.abs().max()) for w in want.values())
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"{what} {n}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_context_step_equals_one_process(ranks, case):
    got, ref = ranks
    for r, res in enumerate(got):
        (gm, gp), (wm, wp) = res[case], ref[case]
        assert len(gm) == len(wm) == STEPS
        np.testing.assert_allclose(np.array(gm), np.array(wm), rtol=STEP_TOL,
                                   atol=0, err_msg=f"{case} rank {r}")
        _close_params(gp, wp, STEP_TOL, f"{case} rank {r}")


def test_ast_levels_banded_and_gathered():
    """At 32x32, window 8, context 4 the AST's encoder levels run on bands
    down to 4x4, the bottleneck and the decoders at 4x4 to 16x16 run whole,
    the last decoder on bands (the gather path of ``cp_ops.between`` and
    ``relayout`` runs)."""
    cp = meshes.ContextParallel(0, 4)
    m = init_model("AST", device="cpu", cp=cp, **AST_KW)
    enc = [m._level_banded(getattr(m, f"encoderlayer_{i}"), 32 >> i)
           for i in range(4)]
    dec = [m._level_banded(getattr(m, f"decoderlayer_{i}"), 32 >> (3 - i))
           for i in range(4)]
    assert enc == [True] * 4
    assert m._level_banded(m.conv, 2) is False
    assert dec == [False, False, False, True]
