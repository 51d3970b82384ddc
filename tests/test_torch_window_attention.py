"""The port's window attention (ops/window_attention.py, ops/attention.py)
against the JAX package, on the CPU.

- ``window_attention_plain`` vs ``ops/attention.py window_attention_core``
  and vs the TPU kernel ``ops/pallas.py window_attention`` in interpret
  mode: dense and sparse, with and without the shift mask, 2 and 16 heads,
  f32 and bf16;
- ``window_attention_bwd`` (the CUDA route's recompute backward) vs
  ``jax.vjp`` of the Pallas function: dq, dk, dv, dbias and dw;
- the CPU route takes the plain version and counts no launch;
- ``split_heads``/``merge_heads``/``sparse_mix_weights`` vs the JAX ones;
- the CUDA kernels' algorithms, emulated in torch at their rounding points
  (``_emulate_forward``, ``_emulate_backward``), vs the Pallas function and
  ``jax.vjp`` of it, at d = 8 and at d = 128 (the New* models' widest
  heads, whose output products walk the head width in 64-channel halves),
  and the planners that split the windows over blocks (their shared memory
  mirrored from the kernels', one block an SM at d = 128).

Inputs are drawn so the attention is far from uniform: q, k ~ N(0, 1)
with head width 8 (scores O(1)), a bias table of std 1 and mix weights
(0.3, -0.4).  Tolerances: f32 1e-5 x max(1, max|ref|) (f32 sums in another
order); bf16 8e-3 x max|ref|, two bf16 ulps (both sides compute in f32 and
round once, so a result near a rounding boundary may land one ulp apart);
gradients 1e-4 x max(1, max|ref|), f32 (dbias sums over every window, dw
over every score: 2.8e-5 of |dw| seen).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.ops import attention as jax_attention
from underwater_image_restoration_tpu.ops import pallas
from underwater_image_restoration_tpu.ops import windows as jax_windows
from underwater_image_restoration_torch.ops import attention

# the module (``ops.window_attention`` is also the name of its function)
wa = importlib.import_module(
    "underwater_image_restoration_torch.ops.window_attention")

TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _case(heads, ws, masked, sparse, seed=0, batch=2, hw=8, d=8):
    rng = np.random.default_rng(seed)
    n = ws * ws
    nw = (hw // ws) ** 2
    shape = (batch * nw, heads, n, d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = (jax_windows.shift_window_mask(hw, hw, ws, ws // 2)
            if masked else None)
    w = np.array([0.3, -0.4], np.float32) if sparse else None
    return q, k, v, bias, w, mask, d ** -0.5


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


CASES = [(2, 4, False, False), (2, 4, True, True), (16, 2, False, True),
         (16, 4, True, False)]
IDS = ["dense", "sparse-masked", "sparse-16heads", "dense-masked-16heads"]


@pytest.mark.parametrize("heads, ws, masked, sparse", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_core(heads, ws, masked, sparse, dtype):
    q, k, v, bias, w, mask, scale = _case(heads, ws, masked, sparse)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = wa.window_attention_plain(
        *(_t(a, tdt) for a in (q, k, v)), _t(bias), scale=scale,
        sparse_w=_t(w), mask=_t(mask))
    assert got.dtype == tdt
    got = got.float().numpy()
    jin = [_j(a, jdt) for a in (q, k, v)] + [_j(bias)]
    for ref in (jax_attention.window_attention_core,
                lambda *a, **kw: pallas.window_attention(*a, **kw,
                                                         interpret=True)):
        want = np.asarray(ref(*jin, scale=scale, sparse_w=_j(w),
                              mask=_j(mask))).astype(np.float32)
        lim = TOL[dtype] * (max(1.0, np.abs(want).max()) if dtype ==
                            "float32" else np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=lim, rtol=0)


@pytest.mark.parametrize("heads, ws, masked, sparse", CASES[:2],
                         ids=IDS[:2])
def test_recompute_backward_matches_pallas_vjp(heads, ws, masked, sparse):
    q, k, v, bias, w, mask, scale = _case(heads, ws, masked, sparse, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    got = wa.window_attention_bwd(
        _t(g), *(_t(a) for a in (q, k, v, bias)), scale=scale,
        sparse_w=_t(w), mask=_t(mask))
    args = [_j(a) for a in (q, k, v, bias)] + ([_j(w)] if sparse else [])

    def f(*a):
        return pallas.window_attention(*a[:4], scale=scale,
                                       sparse_w=a[4] if sparse else None,
                                       mask=_j(mask), interpret=True)

    want = jax.vjp(f, *args)[1](jnp.asarray(g))
    assert (got[4] is None) == (not sparse)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        np.testing.assert_allclose(
            a.numpy(), b, atol=1e-4 * max(1.0, np.abs(b).max()), rtol=0,
            err_msg=f"gradient {i}")


def test_backward_skips_what_is_not_needed():
    q, k, v, bias, w, mask, scale = _case(2, 4, True, True, seed=3)
    got = wa.window_attention_bwd(
        _t(q), *(_t(a) for a in (q, k, v, bias)), scale=scale,
        sparse_w=_t(w), mask=_t(mask), need=(True, False, True, False, True))
    assert got[1] is None and got[3] is None
    assert all(t is not None for t in (got[0], got[2], got[4]))


def test_cpu_tensor_takes_plain_version():
    q, k, v, bias, w, mask, scale = _case(2, 4, True, True, seed=4)
    before = sum(wa.window_attention.launches.values())
    args = [_t(a) for a in (q, k, v, bias)]
    got = wa.window_attention(*args, scale=scale, sparse_w=_t(w),
                              mask=_t(mask))
    want = wa.window_attention_plain(*args, scale=scale, sparse_w=_t(w),
                                     mask=_t(mask))
    assert torch.equal(got, want)
    assert sum(wa.window_attention.launches.values()) == before


def test_head_helpers_match_jax():
    x = np.random.default_rng(5).standard_normal((3, 16, 24)).astype(
        np.float32)
    heads = attention.split_heads(torch.from_numpy(x), 4)
    want = np.asarray(jax_attention.split_heads(jnp.asarray(x), 4))
    np.testing.assert_array_equal(heads.numpy(), want)
    np.testing.assert_array_equal(attention.merge_heads(heads).numpy(), x)
    w = np.array([0.7, -1.2], np.float32)
    got = attention.sparse_mix_weights(torch.from_numpy(w))
    want = jax_attention.sparse_mix_weights(jnp.asarray(w))
    np.testing.assert_allclose([float(t) for t in got],
                               [float(t) for t in want], rtol=1e-6)


# ---- the CUDA kernels' algorithms, emulated on the CPU
#
# csrc/window_attn.cu and csrc/window_attn_bwd.cu run every product on the
# tensor cores with bf16 operand planes (csrc/mma.cuh, csrc/wattn.cuh): a
# bf16 operand is one plane; an f32 one three, hi = bf16(t), mid =
# bf16(t - hi) and lo = bf16(t - hi - mid), a product taking the six passes
# (i, j) with i + j <= 2 (two planes leave too little room under the
# limit for the backward's dw, a difference of sums that cancel); the
# passes accumulate in f32 (emulated here exactly in f64, then rounded
# once).  P (and dS in the backward) are built in f32 registers and
# split the same way: one bf16 plane in a bf16 call, three in an f32 call.
# The scale multiplies the f32 products (q is never rounded after
# scaling), added to bias + mask staged as one f32 tile.  The backward's
# dbias sums each block's windows in f32 in its walk order
# (``block_windows``), then the blocks' rows in block order; its dP sm and
# dP relu(S)^2 sums go through f64.
#
# Tolerances, the card's (chip_smoke.py AST_KERNEL_TOL, GRAD_TOL): forward
# max abs error over max|ref|, f32 5e-5 (the planes hold about 2^-24 of
# each product), bf16 2e-2 (P as one bf16 plane moves out by at most a
# bf16 ulp of P's sum, and both round out to bf16); gradients, each over
# its max|ref|, f32 1e-4, bf16 2e-2.  A copy that scaled its output or dq
# by 1.05 would read about 5e-2.

EMU_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
EMU_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _planes(t, dtype):
    """The bf16 planes of an operand, as f64: one in a bf16 call, three in
    an f32 one (plane i the bf16 of what planes 0 .. i - 1 leave)."""
    rest, out = t.float(), []
    for _ in range(1 if dtype == torch.bfloat16 else 3):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return [p.double() for p in out]


def _prod(eq, a, b):
    """A tensor-core product of plane lists a and b of one length: the
    passes (i, j) with i + j < len(a), summed exactly and rounded to f32
    once."""
    return sum(torch.einsum(eq, a[i], b[j]) for i in range(len(a))
               for j in range(len(a) - i)).float()


def _recompute(q, k, bias, w, mask, scale):
    """The kernels' scores S, softmax sm, relu(S) and P in f32, and (w1,
    w2)."""
    dt = q.dtype
    bq, h, n, _ = q.shape
    bm = bias.float()[None].expand(bq, h, n, n)
    if mask is not None:
        nw = mask.shape[0]
        bm = (bias.float()[None, None] + mask.float()[None, :, None]).expand(
            bq // nw, nw, h, n, n).reshape(bq, h, n, n)
    prod = _prod("bhnd,bhmd->bhnm", _planes(q, dt), _planes(k, dt))
    s = (prod.double() * scale + bm.double()).float()  # one fma a score
    sm = torch.softmax(s, dim=-1)
    r = torch.relu(s)
    w1, w2 = ((1.0, 0.0) if w is None
              else tuple(float(x) for x in attention.sparse_mix_weights(w)))
    return s, sm, r, sm * w1 + r * r * w2, w1, w2


def _halves(eq, a, b):
    """A product whose output runs over the head width (P v, dS k, P^T dO,
    dS^T q), taken a half of at most 64 channels of ``b`` at a time, as the
    kernels walk d > 64 (wattn.cuh rows_out, cols_out)."""
    d = b[0].shape[-1]
    return torch.cat([_prod(eq, a, [t[..., i:i + 64] for t in b])
                      for i in range(0, d, 64)], -1)


def _emulate_forward(q, k, v, bias, w, mask, scale):
    """csrc/window_attn.cu's output, in q's dtype."""
    p = _recompute(q, k, bias, w, mask, scale)[3]
    return _halves("bhnm,bhmd->bhnd", _planes(p, q.dtype),
                   _planes(v, q.dtype)).to(q.dtype)


def _emulate_backward(g, q, k, v, bias, w, mask, scale, sms):
    """csrc/window_attn_bwd.cu's (dq, dk, dv, dbias, dw): the products on
    the operand planes, dbias and the dw sums in the kernel's block split
    (``bwd_plan`` for ``sms`` multiprocessors) and order."""
    dt = q.dtype
    bq, h, n, _ = q.shape
    _, sm, r, p, w1, w2 = _recompute(q, k, bias, w, mask, scale)

    def pl(t):
        return _planes(t, dt)

    dv = _halves("bhnm,bhnd->bhmd", pl(p), pl(g))
    dp = _prod("bhnd,bhmd->bhnm", pl(g), pl(v))
    rs = (dp * sm).sum(-1, keepdim=True)
    ds = w1 * sm * (dp - rs) + 2 * w2 * r * dp
    dq = _halves("bhnm,bhmd->bhnd", pl(ds), pl(k)) * scale
    dk = _halves("bhnm,bhnd->bhmd", pl(ds), pl(q)) * scale
    t1 = (dp * sm).sum((-2, -1))          # (B', H) f32 window sums
    t2 = (dp * r * r).sum((-2, -1))
    plan = wa.bwd_plan(bq, h, n, sms, d=q.shape[-1],
                       itemsize=q.element_size())
    nw = 1 if mask is None else mask.shape[0]
    dbias = torch.zeros(h, n, n)
    s1 = s2 = 0.0
    for hh in range(h):
        for blk in range(plan.blocks_per_head):
            tile = torch.zeros(n, n)
            for b in wa.block_windows(bq, nw, plan.windows_per_block, blk):
                tile = tile + ds[b, hh]
                s1 += float(t1[b, hh])
                s2 += float(t2[b, hh])
            dbias[hh] = dbias[hh] + tile
    dw = (None if w is None
          else torch.tensor([w1 * w2 * (s1 - s2), -w1 * w2 * (s1 - s2)]))
    return dq.to(dt), dk.to(dt), dv.to(dt), dbias, dw


@pytest.mark.parametrize("heads, ws, masked, sparse", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_forward_matches_pallas(heads, ws, masked, sparse, dtype):
    q, k, v, bias, w, mask, scale = _case(heads, ws, masked, sparse, seed=6)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = _emulate_forward(*(_t(a, tdt) for a in (q, k, v)), _t(bias),
                           _t(w), _t(mask), scale)
    assert got.dtype == tdt
    want = np.asarray(pallas.window_attention(
        *(_j(a, jdt) for a in (q, k, v)), _j(bias), scale=scale,
        sparse_w=_j(w), mask=_j(mask), interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=EMU_TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("heads, ws, masked, sparse", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_backward_matches_pallas_vjp(heads, ws, masked, sparse,
                                              dtype):
    q, k, v, bias, w, mask, scale = _case(heads, ws, masked, sparse, seed=7)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    # an SM count that gives every head three blocks
    sms = -(-3 * heads // wa.blocks_per_sm(wa.bwd_smem_bytes(
        8, tdt.itemsize)))
    got = _emulate_backward(_t(g, tdt), *(_t(a, tdt) for a in (q, k, v)),
                            _t(bias), _t(w), _t(mask), scale, sms=sms)
    args = [_j(a, jdt) for a in (q, k, v)] + [_j(bias)] + (
        [_j(w)] if sparse else [])

    def f(*a):
        return pallas.window_attention(*a[:4], scale=scale,
                                       sparse_w=a[4] if sparse else None,
                                       mask=_j(mask), interpret=True)

    want = jax.vjp(f, *args)[1](jnp.asarray(g).astype(jdt))
    assert (got[4] is None) == (not sparse)
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dw"), got, want):
        b = np.asarray(b).astype(np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            a.float().numpy(), b, rtol=0,
            atol=EMU_GRAD_TOL[dtype] * np.abs(b).max(), err_msg=name)


# (head width, itemsize) of the planners' checks: the AST's d = 32 in bf16,
# the New* models' d = 16 and d = 128, in bf16 and f32
PLAN_WIDTHS = ((32, 2), (16, 2), (128, 2), (128, 4), (16, 4))


@pytest.mark.parametrize("bq, heads, n, nw, sms", [
    (8192, 2, 64, 1024, 132), (16384, 2, 64, 1, 132), (32, 16, 64, 4, 132),
    (8, 2, 16, 4, 1), (21, 3, 4, 7, 5)])
def test_plans_cover_every_window_once(bq, heads, n, nw, sms):
    """Every window is walked exactly once a head, by blocks of at most
    windows_per_block, and the backward's rows fit their budget."""
    for d, size in PLAN_WIDTHS:
        for plan in (wa.fwd_plan(bq, heads, sms, d=d, itemsize=size),
                     wa.bwd_plan(bq, heads, n, sms, d=d, itemsize=size)):
            seen = []
            for blk in range(plan.blocks_per_head):
                run = wa.block_windows(bq, nw, plan.windows_per_block, blk)
                assert 1 <= len(run) <= plan.windows_per_block
                seen += run
            assert sorted(seen) == list(range(bq))
        plan = wa.bwd_plan(bq, heads, n, sms, d=d, itemsize=size)
        assert plan.workspace == plan.blocks_per_head * heads * \
            wa.bwd_row_bytes(n) <= wa.BWD_WORKSPACE_BYTES
        per_sm = wa.blocks_per_sm(wa.bwd_smem_bytes(d, size))
        assert plan.blocks_per_head <= -(-per_sm * sms // heads)


def test_backward_plan_keeps_its_budget(monkeypatch):
    """A smaller workspace budget gives fewer, longer blocks a head, and
    they still cover every window."""
    monkeypatch.setattr(wa, "BWD_WORKSPACE_BYTES", 10 * wa.bwd_row_bytes(64))
    plan = wa.bwd_plan(8192, 2, 64, 132, d=32, itemsize=2)
    assert plan.blocks_per_head == 5 and plan.windows_per_block == 1639
    assert plan.workspace <= wa.BWD_WORKSPACE_BYTES
    seen = sorted(b for blk in range(5)
                  for b in wa.block_windows(8192, 1024, 1639, blk))
    assert seen == list(range(8192))


def test_plans_at_wide_heads():
    """The planners' shared memory, the kernels' smem_bytes: at d = 32 in
    bf16 four forward blocks and two backward an SM (the AST's plans,
    unchanged); at d = 128 every block fits the 227 KiB a block may take
    (the f32 backward in two operand slots) and an SM holds one, so a
    NewModel@256 call at batch 8 walks its 128 or 32 windows in one wave
    of 132 blocks or fewer."""
    limit = 227 << 10
    assert (wa.fwd_smem_bytes(32, 2), wa.bwd_smem_bytes(32, 2)) == (54272,
                                                                   101440)
    assert wa.blocks_per_sm(54272) == 4 and wa.blocks_per_sm(101440) == 2
    assert (wa.fwd_smem_bytes(128, 2), wa.fwd_smem_bytes(128, 4)) == (
        132096, 192512)
    assert (wa.bwd_smem_bytes(128, 2), wa.bwd_smem_bytes(128, 4)) == (
        203840, 214080)
    for d in (65, 96, 128):
        for size in (2, 4):
            for smem in (wa.fwd_smem_bytes(d, size),
                         wa.bwd_smem_bytes(d, size)):
                assert smem <= limit and wa.blocks_per_sm(smem) == 1
    for bq in (128, 32):
        plan = wa.fwd_plan(bq, 4, 132, d=128, itemsize=2)
        assert plan.blocks_per_head * 4 <= 132
        assert plan.blocks_per_head * plan.windows_per_block >= bq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_wide_heads_match_pallas(dtype):
    """d = 128 (NewModel's decoder 3 and bottleneck): the emulated kernels,
    whose P v, dq, dk and dv walk the width in halves while S and dP sum
    over all of it, vs the Pallas function in interpret mode and its
    ``jax.vjp``, masked and sparse, N = 64."""
    q, k, v, bias, w, mask, scale = _case(2, 8, True, True, seed=10,
                                          batch=1, hw=16, d=128)
    g = np.random.default_rng(11).standard_normal(q.shape).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = [_j(a, jdt) for a in (q, k, v)] + [_j(bias), _j(w)]

    def f(*a):
        return pallas.window_attention(*a[:4], scale=scale, sparse_w=a[4],
                                       mask=_j(mask), interpret=True)

    want, vjp = jax.vjp(f, *args)
    got = _emulate_forward(*(_t(a, tdt) for a in (q, k, v)), _t(bias),
                           _t(w), _t(mask), scale)
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=EMU_TOL[dtype] * np.abs(want).max())
    grads = _emulate_backward(_t(g, tdt), *(_t(a, tdt) for a in (q, k, v)),
                              _t(bias), _t(w), _t(mask), scale, sms=2)
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dw"), grads,
                          vjp(jnp.asarray(g).astype(jdt))):
        b = np.asarray(b).astype(np.float32)
        np.testing.assert_allclose(
            a.float().numpy(), b, rtol=0,
            atol=EMU_GRAD_TOL[dtype] * np.abs(b).max(), err_msg=name)


def test_cpu_backward_takes_plain_version():
    q, k, v, bias, w, mask, scale = _case(2, 4, True, True, seed=9)
    before = sum(wa.window_attn_bwd.launches.values())
    args = [_t(a) for a in (q, k, v, bias)]
    got = wa.window_attn_bwd(_t(q), *args, scale=scale, sparse_w=_t(w),
                             mask=_t(mask))
    want = wa.window_attention_bwd(_t(q), *args, scale=scale,
                                   sparse_w=_t(w), mask=_t(mask))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(wa.window_attn_bwd.launches.values()) == before
