"""The port's window attention (ops/window_attention.py, ops/attention.py)
against the JAX package, on the CPU.

- ``window_attention_plain`` vs ``ops/attention.py window_attention_core``
  and vs the TPU kernel ``ops/pallas.py window_attention`` in interpret
  mode: dense and sparse, with and without the shift mask, 2 and 16 heads,
  f32 and bf16;
- ``window_attention_bwd`` (the CUDA route's recompute backward) vs
  ``jax.vjp`` of the Pallas function: dq, dk, dv, dbias and dw;
- the CPU route takes the plain version and counts no launch;
- ``split_heads``/``merge_heads``/``sparse_mix_weights`` vs the JAX ones.

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
