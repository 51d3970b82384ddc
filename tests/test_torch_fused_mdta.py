"""The port's LN+MDTA (ops/fused_mdta.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU, with 2 heads.

- plain ``ln_mdta`` vs ``fused_attn_composed.fused_ln_mdta_composed``,
  ``fused_attn_banded.fused_ln_mdta_banded`` and ``fused_attn.fused_ln_mdta``
  at (1, 8, 16, 128), and vs the composed and banded kernels at (1, 8, 8, 64)
  (fused_attn takes only W % 128 == 0);
- the CUDA kernels' two-launch algorithm (per-head gram and row norms, then
  A rebuilt from them and applied) over their own operands gives the same
  function.
- ``ln_mdta_bwd_plain`` (autograd through the plain version) vs ``jax.vjp``
  of the composed (TPU kernel row 4), banded (row 6) and shift-MAC (row 10)
  kernels at the forward test's shapes: all ten gradients, dtemp included,
  and exact zeros on the dead ``kf`` half of w_kv / t_kv;
- the CUDA backward's algorithm (csrc/ln_mdta_bwd.cu: partial dA, the
  per-image softmax and l2-normalize backward from the saved stats, then
  the transposed chains) gives the plain backward's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _dy(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("ref, shape", [
    (fused_attn_composed.fused_ln_mdta_composed, (1, C, 16, 128)),
    (fused_attn_banded.fused_ln_mdta_banded, (1, C, 16, 128)),
    (fused_attn.fused_ln_mdta, (1, C, 16, 128)),
    (fused_attn_composed.fused_ln_mdta_composed, (1, C, 8, 64)),
    (fused_attn_banded.fused_ln_mdta_banded, (1, C, 8, 64)),
], ids=["composed-16x128", "banded-16x128", "shiftmac-16x128",
        "composed-8x64", "banded-8x64"])
def test_plain_backward_matches_pallas_vjp(ref, shape):
    x, w = _case(shape)
    dy = _dy(shape)

    def f(*args):
        return ref(*args, num_heads=NH)

    _, vjp = jax.vjp(f, jnp.asarray(x), *(jnp.asarray(a) for a in w))
    want = vjp(jnp.asarray(dy))
    got = fused_mdta.ln_mdta_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dy),
        *(torch.from_numpy(a) for a in w), NH)
    assert len(got) == len(want) == 10
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r)
    # the dead kf half of kv / kv_conv: exact zeros on both sides
    for i in (7, 8):
        assert not got[i][..., :C].any() and not np.asarray(want[i])[
            ..., :C].any()
    assert got[5].shape == (1, NH, 1, 1) and got[5].abs().max() > 0


def _tap_t(d, taps):
    """sum_k taps[:, k] d(p - d_k): the transposed zero-padded 3x3."""
    c = d.shape[1]
    return F.conv2d(d, taps.flip(1).reshape(c, 1, 3, 3), padding=1,
                    groups=c)


def _tap_grad(d, u):
    """(C, 9): sum_p d(p) u(p + d_k), the depthwise taps' gradient."""
    b, c, h, w = u.shape
    cols = F.unfold(u.reshape(b * c, 1, h, w), 3, padding=1)
    return torch.einsum("bcl,bckl->ck", d.reshape(b, c, h * w),
                        cols.reshape(b, c, 9, h * w))


def _emulate_backward(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                      t_kv, w_pof, nh):
    """The CUDA backward's three steps over its operands.  (a) v pass: the
    forward recomputed, then d_outf = W_pof dy, dvf = A^T d_outf, d(u_vf)
    by the transposed taps, d_out = W_kvf d(u_vf), d_outs = W_po d_out,
    dv = A^T d_outs, and dA = sum d_outf vf^T + d_outs v^T with the weight
    gradients of that chain.  Per image, from the saved stats (G, Sq, Sk):
    dS = A (dA - rowsum(dA A)), dtemp = sum dS G rq rk, dP = temp dS, M =
    rq dP rk^T, alpha = r^3 sum dP G r' (zero where S < 1e-24).  (b) q/k
    pass: dq = M k - alpha_q q, dk = M^T q - alpha_k k, the transposed taps
    and 1x1 of [dq; dk; dv] to dLN, the LN backward, dx = dy + dx_ln."""
    b, c, h, w = x.shape
    cph, L = c // nh, h * w
    taps3 = t_qkv.reshape(9, 3 * c).t()
    wvf, tvf = w_kv[:, c:], t_kv.reshape(9, 2 * c).t()[c:]
    conv1x1, dwconv3x3 = fused_mdta.conv1x1, fused_mdta.dwconv3x3

    def hd(t):
        return t.reshape(b, nh, cph, L)

    def un(t):
        return t.reshape(b, c, h, w)

    def att(a, t):
        return un(torch.einsum("bhij,bhjl->bhil", a, hd(t)))

    def att_t(a, t):
        return un(torch.einsum("bhij,bhil->bhjl", a, hd(t)))

    ln = layer_norm_channels(x, scale, bias)
    u = conv1x1(ln, w_qkv)
    q, k, v = dwconv3x3(u, taps3.t().reshape(3, 3, 3 * c)).split(c, 1)
    g = torch.einsum("bhil,bhjl->bhij", hd(q), hd(k))
    sq, sk = hd(q).square().sum(-1), hd(k).square().sum(-1)
    rq = torch.rsqrt(torch.clamp_min(sq, 1e-24))
    rk = torch.rsqrt(torch.clamp_min(sk, 1e-24))
    tt = temp.view(1, nh, 1, 1)
    a = torch.softmax(g * rq[..., None] * rk[..., None, :] * tt, -1)
    # (a) the v pass
    outs = att(a, v)
    out = conv1x1(outs, w_po)
    uvf = conv1x1(out, wvf)
    vf = dwconv3x3(uvf, tvf.t().reshape(3, 3, c))
    d_outf = conv1x1(dy, w_pof.t())
    dvf = att_t(a, d_outf)
    duvf = _tap_t(dvf, tvf)
    d_out = conv1x1(duvf, wvf.t())
    d_outs = conv1x1(d_out, w_po.t())
    da = (torch.einsum("bhil,bhjl->bhij", hd(d_outf), hd(vf))
          + torch.einsum("bhil,bhjl->bhij", hd(d_outs), hd(v)))
    # per image, from the saved stats
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dtemp = (ds * g * rq[..., None] * rk[..., None, :]).sum((0, 2, 3))
    dp = tt * ds
    m = rq[..., None] * dp * rk[..., None, :]
    aq = torch.where(sq >= 1e-24,
                     rq ** 3 * (dp * g * rk[..., None, :]).sum(-1), 0)
    ak = torch.where(sk >= 1e-24, rk ** 3 * (dp * g * rq[..., None]).sum(-2),
                     0)
    # (b) the q/k pass
    dq = torch.einsum("bhij,bhjl->bhil", m, hd(k)) - aq[..., None] * hd(q)
    dk = torch.einsum("bhij,bhil->bhjl", m, hd(q)) - ak[..., None] * hd(k)
    dqkv = torch.cat([un(dq), un(dk), att_t(a, d_outs)], 1)
    du = _tap_t(dqkv, taps3)
    xm = x - x.mean(1, keepdim=True)
    rstd = torch.rsqrt(xm.square().mean(1, keepdim=True) + 1e-5)
    xh = xm * rstd
    dln = conv1x1(du, w_qkv.t())
    gl = dln * scale.view(1, -1, 1, 1)
    dx = dy + rstd * (gl - gl.mean(1, keepdim=True)
                      - xh * (gl * xh).mean(1, keepdim=True))
    zero = torch.zeros(c, c)
    return (dx, (dln * xh).sum((0, 2, 3)), dln.sum((0, 2, 3)),
            torch.einsum("bchw,bkhw->ck", ln, du),
            _tap_grad(dqkv, u).t().reshape(3, 3, 3 * c), dtemp.view(tt.shape),
            torch.einsum("bihw,bohw->io", outs, d_out),
            torch.cat([zero, torch.einsum("bihw,bohw->io", out, duvf)], 1),
            torch.cat([zero[:, :9], _tap_grad(dvf, uvf)]).t().reshape(
                3, 3, 2 * c),
            torch.einsum("bihw,bohw->io", att(a, vf), dy))


def test_backward_kernel_algorithm():
    x, w = _case((2, 16, 8, 12), seed=6)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape), *w)]
    got = _emulate_backward(*args, NH)
    want = fused_mdta.ln_mdta_bwd_plain(*args, NH)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r.numpy())


def test_backward_kernel_refuses_cpu_tensor():
    """The backward's wrapper launches the CUDA kernels only; on the CPU,
    autograd differentiates ``ln_mdta_plain`` and never reaches it."""
    x, w = _case((1, C, 8, 8), seed=2)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape), *w)]
    stats = torch.zeros(C * (C // NH) + 2 * C)
    before = sum(fused_mdta.ln_mdta_bwd.launches.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mdta.ln_mdta_bwd(*args, NH, stats)
    assert sum(fused_mdta.ln_mdta_bwd.launches.values()) == before
