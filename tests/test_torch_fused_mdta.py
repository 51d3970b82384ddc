"""The port's LN+MDTA (ops/fused_mdta.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU, with 2 heads.

- plain ``ln_mdta`` vs ``fused_attn_composed.fused_ln_mdta_composed``,
  ``fused_attn_banded.fused_ln_mdta_banded`` and ``fused_attn.fused_ln_mdta``
  at (1, 8, 16, 128), and vs the composed and banded kernels at (1, 8, 8, 64)
  (fused_attn takes only W % 128 == 0);
- the CUDA kernels' two-launch algorithm (per-head gram and row norms, then
  A rebuilt from them and applied) over their own operands gives the same
  function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.ops import (
    fused_attn,
    fused_attn_banded,
    fused_attn_composed,
)
from underwater_image_restoration_torch.ops import fused_mdta
from underwater_image_restoration_torch.ops.layers import layer_norm_channels

C, NH = 8, 2
TOL = 3e-5  # x max(1, max|ref|), as tests/test_fused_attn_composed.py


def _case(shape, nh=NH, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]

    def u(bound, *s):
        return rng.uniform(-bound, bound, s).astype(np.float32)

    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c).astype(np.float32),
         0.1 * rng.standard_normal(c).astype(np.float32),
         u(c ** -0.5, c, 3 * c), u(1 / 3, 3, 3, 3 * c),
         rng.uniform(0.5, 2.0, (1, nh, 1, 1)).astype(np.float32),
         u(c ** -0.5, c, c), u(c ** -0.5, c, 2 * c), u(1 / 3, 3, 3, 2 * c),
         u(c ** -0.5, c, c))
    return x, w


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _port(fn, x, w, nh=NH):
    return fn(torch.from_numpy(x), *(torch.from_numpy(a) for a in w), nh)


@pytest.mark.parametrize("ref, shape", [
    (fused_attn_composed.fused_ln_mdta_composed, (1, C, 16, 128)),
    (fused_attn_banded.fused_ln_mdta_banded, (1, C, 16, 128)),
    (fused_attn.fused_ln_mdta, (1, C, 16, 128)),
    (fused_attn_composed.fused_ln_mdta_composed, (1, C, 8, 64)),
    (fused_attn_banded.fused_ln_mdta_banded, (1, C, 8, 64)),
], ids=["composed-16x128", "banded-16x128", "shiftmac-16x128",
        "composed-8x64", "banded-8x64"])
def test_plain_matches_pallas(ref, shape):
    x, w = _case(shape)
    want = ref(jnp.asarray(x), *(jnp.asarray(a) for a in w), num_heads=NH)
    _close(_port(fused_mdta.ln_mdta, x, w).numpy(), want)


def test_cpu_tensor_takes_plain_version():
    x, w = _case((2, C, 8, 8), seed=3)
    before = sum(fused_mdta.ln_mdta.launches.values())
    got = _port(fused_mdta.ln_mdta, x, w)
    assert torch.equal(got, _port(fused_mdta.ln_mdta_plain, x, w))
    assert sum(fused_mdta.ln_mdta.launches.values()) == before


def _emulate_kernels(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                     w_pof, nh):
    """The CUDA kernels' algorithm over their own operands.  Stats launch:
    q, k as 1x1 then taps, per-head gram G and row sums of squares.  Apply
    launch: A = softmax(temp * G * rq * rk^T) with rq = rsqrt(max(Sq,
    1e-24)), then v, A v, project_out, vf, A vf, project_outf, residual."""
    b, c, h, w = x.shape
    cph = c // nh
    wqk, tqk, wv, tv, wvf, tvf = fused_mdta.kernel_weights(w_qkv, t_qkv,
                                                           w_kv, t_kv)

    def chain(t, w1, taps):
        return fused_mdta.dwconv3x3(fused_mdta.conv1x1(t, w1),
                                    taps.t().reshape(3, 3, -1))

    def heads(t):
        return t.reshape(b, nh, cph, h * w)

    ln = layer_norm_channels(x, scale, bias)
    qk = chain(ln, wqk, tqk)
    qh, kh = heads(qk[:, :c]), heads(qk[:, c:])
    g = torch.einsum("bhil,bhjl->bhij", qh, kh)
    rq = torch.rsqrt(torch.clamp_min(qh.square().sum(-1), 1e-24))
    rk = torch.rsqrt(torch.clamp_min(kh.square().sum(-1), 1e-24))
    a = torch.softmax(g * rq[..., :, None] * rk[..., None, :]
                      * temp.view(1, nh, 1, 1), dim=-1)
    outs = torch.einsum("bhij,bhjl->bhil", a, heads(chain(ln, wv, tv)))
    out = fused_mdta.conv1x1(outs.reshape(b, c, h, w), w_po)
    outf = torch.einsum("bhij,bhjl->bhil", a, heads(chain(out, wvf, tvf)))
    return x + fused_mdta.conv1x1(outf.reshape(b, c, h, w), w_pof)


def test_kernel_algorithm():
    x, w = _case((2, C, 8, 12), seed=5)
    _close(_port(_emulate_kernels, x, w).numpy(),
           _port(fused_mdta.ln_mdta_plain, x, w).numpy())
