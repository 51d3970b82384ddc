"""The port's LN+MDTA (ops/fused_mdta.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU, with 2 heads.

- plain ``ln_mdta`` vs ``fused_attn_composed.fused_ln_mdta_composed``,
  ``fused_attn_banded.fused_ln_mdta_banded`` and ``fused_attn.fused_ln_mdta``
  at (1, 8, 16, 128), and vs the composed and banded kernels at (1, 8, 8, 64)
  (fused_attn takes only W % 128 == 0);
- the CUDA forward's staged algorithm (csrc/ln_mdta.cu): the batch in image
  slices, every product as the tensor cores take it (operands as bf16
  planes), each image's gram in rows over pixel ranges and its Sq, Sk in
  rows an image row, summed in order, A per image: the plain version's
  output in f32 and bf16, and the plain version's gram and sums of squares
  as the stats the backward reads;
- ``ln_mdta_bwd_plain`` (autograd through the plain version) vs ``jax.vjp``
  of the composed (TPU kernel row 4), banded (row 6) and shift-MAC (row 10)
  kernels at the forward test's shapes: all ten gradients, dtemp included,
  and exact zeros on the dead ``kf`` half of w_kv / t_kv;
- the CUDA backward's staged algorithm (csrc/ln_mdta_bwd.cu): the batch in
  image slices, every 1x1 and per-head product as the tensor cores take it
  (operands as bf16 planes: in bf16 one for a value rounded to bf16 and two
  for an f32 value, in f32 three for every value), dA in rows over pixel
  ranges of each
  image, the per-image softmax and l2-normalize backward from the stats,
  the weight gradients in rows over pixel ranges, the taps' gradients in
  rows an image row, every row summed in order: the plain backward's
  gradients in f32 and bf16;
- the backward's and the forward's planners (slices within
  BWD_WORKSPACE_BYTES and FWD_WORKSPACE_BYTES at every
  SpectralTransformer@256 shape, train batch 16 and serve batch 8); the
  backward's wrapper refuses a CPU tensor.
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


def _planes(t, n):
    """csrc/mma.cuh's n bf16 planes of an operand, as f32: plane k the bf16
    of what planes 0..k-1 leave."""
    out = []
    for _ in range(n):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


def _mm(a, b, na, nb):
    """a @ b as the tensor-core products take it: bf16 operands in na and nb
    planes, f32 sums over the passes (i, j) with i + j <= max(na, nb) - 1,
    in mma_split's order."""
    pa, pb = _planes(a, na), _planes(b, nb)
    top = max(na, nb) - 1
    out = None
    for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)):
        if i < na and j < nb and i + j <= top:
            t = pa[i] @ pb[j]
            out = t if out is None else out + t
    return out


def _in_order(rows):
    out = rows[0]
    for r in rows[1:]:
        out = out + r
    return out


def _taps_pm(u, taps, n, h, w, transposed=False):
    """The depthwise 3x3 on pixel-major (n h w, ch) values, zero outside
    each image: sum_k taps[:, k] u(p + d_k), or with ``transposed``
    sum_k taps[:, k] u(p - d_k)."""
    ch = u.shape[1]
    t = u.reshape(n, h, w, ch).permute(0, 3, 1, 2)
    k = (taps.flip(1) if transposed else taps).reshape(ch, 1, 3, 3)
    out = F.conv2d(t, k, padding=1, groups=ch)
    return out.permute(0, 2, 3, 1).reshape(n * h * w, ch)


def _tap_rows(d, u, n, h, w):
    """The taps' gradient sum_p d(p) u(p + d_k) as rows, one an image row
    (what a segment of the kernel's taps pass writes at W <=
    BWD_TAPS_COLS)."""
    ch = d.shape[1]
    ut = u.reshape(n, h, w, ch).permute(0, 3, 1, 2)
    cols = F.unfold(ut.reshape(n * ch, 1, h, w), 3, padding=1)
    cols = cols.reshape(n, ch, 9, h, w)
    dd = d.reshape(n, h, w, ch).permute(0, 3, 1, 2)
    rows = torch.einsum("bchw,bckhw->bhck", dd, cols)
    return list(rows.reshape(n * h, ch * 9))


def _emulate_forward(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                     w_pof, nh, imgs=1, ksa=32, eps=1e-5):
    """csrc/ln_mdta.cu's staged forward in torch: the batch in slices of
    ``imgs`` images, pixel-major values; per slice LN (rounded), u = LN
    W_qkv, round(q), round(k) and v by the taps; each image's gram in rows
    over ``ksa``-pixel ranges summed in order, Sq and Sk in rows an image
    row (a segment of the kernel's taps pass at W <= BWD_TAPS_COLS) summed
    in order; A = softmax(temp G rq rk^T); outs, out, u_vf, vf, outf; y = x
    + round(outf W_pof); every product with the kernel's operand planes
    (``bwd_planes``) and rounding points.  Returns y and the stats [B][C cph
    + 2C] (gram within the heads, Sq, Sk) the backward reads."""
    dt = x.dtype
    sp, nf = fused_mdta.bwd_planes(x.element_size())
    b, c, h, w = x.shape
    cph, hw = c // nh, h * w
    taps3 = t_qkv.reshape(9, 3 * c).t()
    wkvf, tvf = w_kv[:, c:], t_kv.reshape(9, 2 * c).t()[c:]

    def rnd(t):
        return t.to(dt).float()

    y, stats = torch.empty_like(x), []
    for b0 in range(0, b, imgs):
        xs = x[b0:b0 + imgs].float()
        n, p = xs.shape[0], xs.shape[0] * hw
        xp = xs.permute(0, 2, 3, 1).reshape(p, c)
        mean = xp.mean(1, keepdim=True)
        rstd = torch.rsqrt((xp - mean).square().mean(1, keepdim=True) + eps)
        ln = rnd((xp - mean) * rstd * scale + bias)
        qkv = _taps_pm(_mm(ln, w_qkv, sp, nf), taps3, n, h, w)
        q, k, v = rnd(qkv[:, :c]), rnd(qkv[:, c:2 * c]), qkv[:, 2 * c:]
        abd = []
        for i in range(n):
            qi, ki = q[i * hw:(i + 1) * hw], k[i * hw:(i + 1) * hw]
            g = _in_order([_mm(qi[r:r + ksa].t(), ki[r:r + ksa], sp, sp)
                           for r in range(0, hw, ksa)])
            gh = torch.stack([g[j * cph:(j + 1) * cph, j * cph:(j + 1) * cph]
                              for j in range(nh)])
            sq, sk = (_in_order(list(t.square().reshape(h, w, c).sum(1)))
                      for t in (qi, ki))
            stats.append(torch.cat([gh.reshape(c, cph).reshape(-1), sq, sk]))
            rq = torch.rsqrt(torch.clamp_min(sq, 1e-24)).reshape(nh, cph)
            rk = torch.rsqrt(torch.clamp_min(sk, 1e-24)).reshape(nh, cph)
            a = torch.softmax(gh * rq[..., None] * rk[:, None, :]
                              * temp.reshape(nh, 1, 1), -1)
            abd.append(torch.block_diag(*a))

        def att(t):  # A t per image, t [pixel][channel] f32 planes
            return torch.cat([_mm(t[i * hw:(i + 1) * hw], abd[i].t(), nf, nf)
                              for i in range(n)])

        outs = rnd(att(v))
        out = rnd(_mm(outs, w_po, sp, nf))
        vf = _taps_pm(_mm(out, wkvf, sp, nf), tvf, n, h, w)
        outf = rnd(att(vf))
        yp = xp + rnd(_mm(outf, w_pof, sp, nf))
        y[b0:b0 + n] = yp.reshape(n, h, w, c).permute(0, 3, 1, 2).to(dt)
    return y, torch.cat(stats)


def _plain_stats(x, scale, bias, w_qkv, t_qkv, nh, eps=1e-5):
    """Each image's gram within the heads, Sq and Sk of round(q) and
    round(k), from the plain version's own operations."""
    b, c, h, w = x.shape
    cph = c // nh
    ln = layer_norm_channels(x, scale, bias, eps).float()
    qk = fused_mdta.dwconv3x3(fused_mdta.conv1x1(ln, w_qkv[:, :2 * c]),
                              t_qkv[:, :, :2 * c]).to(x.dtype).float()
    q = qk[:, :c].reshape(b, nh, cph, h * w)
    k = qk[:, c:].reshape(b, nh, cph, h * w)
    g = torch.einsum("bhil,bhjl->bhij", q, k).reshape(b, c * cph)
    return torch.cat([g, q.square().sum(-1).reshape(b, c),
                      k.square().sum(-1).reshape(b, c)], 1).reshape(-1)


def _strong(w):
    """_case's weights scaled so that the branch y - x is O(1) beside x, as
    the card's checks draw them: unit-variance 1x1s and taps, temperatures
    of 4-16 (a peaked softmax) and project_outf times 4.  (With _case's own,
    the branch is about 0.02: a bf16 ulp of y.)"""
    w = list(w)
    for i in (2, 3, 5, 6, 7, 8):
        w[i] = w[i] * np.float32(3 ** 0.5)
    w[4], w[8] = 8 * w[4], 4 * w[8]
    return w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_algorithm(dtype):
    """Three images in two slices, 16 channels in two heads, 8 x 12 (96
    pixels: gram ranges of 32); y vs the plain version, f32 within TOL of
    max(1, max|ref|), bf16 within 2e-2 of max|branch| (the card's limit:
    a sum on the other side of a rounding boundary moves a bf16 ulp); the
    stats vs the plain version's gram and sums of squares."""
    x, w = _case((3, 16, 8, 12), seed=5)
    args = [torch.from_numpy(a) for a in (x, *_strong(w))]
    args[0] = args[0].to(dtype)
    got, stats = _emulate_forward(*args, NH, imgs=2)
    want = fused_mdta.ln_mdta_plain(*args, NH)
    ref = _plain_stats(args[0], *args[1:5], NH)
    assert stats.shape == (3 * (16 * 8 + 32),)
    if dtype == torch.float32:
        _close(stats.numpy(), ref.numpy())
        _close(got.numpy(), want.numpy())
    else:
        # a q or k value on the other side of a rounding boundary moves its
        # gram entries by a bf16 ulp of it
        np.testing.assert_allclose(stats.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-2 * float(ref.abs().max()))
        branch = (want.float() - args[0].float()).abs().max()
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * branch


def _emulate_backward(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                      t_kv, w_pof, nh, imgs=1, ks=64, ksa=32, eps=1e-5):
    """csrc/ln_mdta_bwd.cu's staged design in torch: the batch in slices of
    ``imgs`` images, pixel-major values; per slice LN and dy (rounded), u =
    LN W_qkv, round(q), round(k) and v by the taps, A of each image from the
    stats the forward saves (gram and row sums of squares of round(q),
    round(k)); outs, out, u_vf, vf, outf; d_outf, dvf, d(u_vf), d_out,
    d_outs, dv; dA in rows over ``ksa``-pixel ranges of each image, summed
    in order, and the softmax and l2-normalize backward; dq, dk; d(u_qkv);
    the weight gradients in rows over ``ks``-pixel ranges of the slice; dLN
    and the LayerNorm backward, dscale and dbias in rows of 32 pixels; every
    product with the kernel's operand planes (``bwd_planes``) and rounding
    points."""
    dt = x.dtype
    # planes of a value rounded to T (sp) and of an f32 value (nf)
    sp, nf = fused_mdta.bwd_planes(x.element_size())
    b, c, h, w = x.shape
    cph, hw = c // nh, h * w
    taps3 = t_qkv.reshape(9, 3 * c).t()
    wkvf, tvf = w_kv[:, c:], t_kv.reshape(9, 2 * c).t()[c:]

    def rnd(t):
        return t.to(dt).float()

    def per_image(t, n):
        return t.reshape(n, hw, t.shape[-1])

    grads, dx, dtemp = None, torch.empty_like(x), torch.zeros(nh)
    for b0 in range(0, b, imgs):
        xs = x[b0:b0 + imgs].float()
        n, p = xs.shape[0], xs.shape[0] * hw
        xp = xs.permute(0, 2, 3, 1).reshape(p, c)
        dyp = dy[b0:b0 + n].float().permute(0, 2, 3, 1).reshape(p, c)
        mean = xp.mean(1, keepdim=True)
        rstd = torch.rsqrt((xp - mean).square().mean(1, keepdim=True) + eps)
        xh = (xp - mean) * rstd
        ln = rnd(xh * scale + bias)
        u = _mm(ln, w_qkv, sp, nf)
        qkv = _taps_pm(u, taps3, n, h, w)
        q, k, v = rnd(qkv[:, :c]), rnd(qkv[:, c:2 * c]), qkv[:, 2 * c:]
        # A of each image, block-diagonal (C, C), from the forward's stats
        qh = per_image(q, n).reshape(n, hw, nh, cph)
        kh = per_image(k, n).reshape(n, hw, nh, cph)
        g = torch.einsum("bphi,bphj->bhij", qh, kh)
        sq, sk = qh.square().sum(1), kh.square().sum(1)
        rq = torch.rsqrt(torch.clamp_min(sq, 1e-24))
        rk = torch.rsqrt(torch.clamp_min(sk, 1e-24))
        tt = temp.reshape(1, nh, 1, 1)
        a = torch.softmax(g * rq[..., None] * rk[..., None, :] * tt, -1)
        abd = torch.stack([torch.block_diag(*a[i]) for i in range(n)])

        def att(t, m, tr):  # t @ m^T (tr False) or t @ m, per image
            mm_ = m if tr else m.transpose(1, 2)
            return torch.cat([_mm(per_image(t, n)[i], mm_[i], sp_t(t), nf)
                              for i in range(n)])

        planes_of = {}

        def sp_t(t):  # an f32 value unless marked as rounded to T
            return planes_of.get(id(t), nf)

        def mark(t, planes):
            planes_of[id(t)] = planes
            return t

        mark(ln, sp), mark(q, sp), mark(k, sp)
        outs = mark(rnd(att(v, abd, False)), sp)
        out = rnd(_mm(outs, w_po, sp, nf))
        uvf = _mm(out, wkvf, sp, nf)
        vf = _taps_pm(uvf, tvf, n, h, w)
        outf = rnd(att(vf, abd, False))
        d_outf = mark(rnd(_mm(dyp, w_pof.t(), sp, nf)), sp)
        dvf = att(d_outf, abd, True)
        duvf = _taps_pm(dvf, tvf, n, h, w, transposed=True)
        rows_tv = _tap_rows(dvf, uvf, n, h, w)
        d_out = rnd(_mm(duvf, wkvf.t(), nf, nf))
        d_outs = mark(rnd(_mm(d_out, w_po.t(), sp, nf)), sp)
        dv = att(d_outs, abd, True)
        # dA of each image: rows over pixel ranges, both products' rows
        da = []
        for i in range(n):
            rows = []
            for lhs, rhs in ((d_outf, vf), (d_outs, v)):
                li, ri = per_image(lhs, n)[i], per_image(rhs, n)[i]
                rows += [_mm(li[r0:r0 + ksa].t(), ri[r0:r0 + ksa], sp, nf)
                         for r0 in range(0, hw, ksa)]
            full = _in_order(rows)
            da.append(torch.stack([full[j * cph:(j + 1) * cph,
                                        j * cph:(j + 1) * cph]
                                   for j in range(nh)]))
        da = torch.stack(da)
        ds = a * (da - (da * a).sum(-1, keepdim=True))
        dtemp = dtemp + (ds * g * rq[..., None] * rk[..., None, :]).sum(
            (2, 3)).sum(0)
        dp = tt * ds
        m = rq[..., None] * dp * rk[..., None, :]
        aq = torch.where(sq >= 1e-24,
                         rq ** 3 * (dp * g * rk[..., None, :]).sum(-1), 0)
        ak = torch.where(sk >= 1e-24,
                         rk ** 3 * (dp * g * rq[..., None]).sum(-2), 0)
        mbd = torch.stack([torch.block_diag(*m[i]) for i in range(n)])
        al_q = aq.reshape(n, 1, c).expand(n, hw, c).reshape(p, c)
        al_k = ak.reshape(n, 1, c).expand(n, hw, c).reshape(p, c)
        dq = rnd(att(k, mbd, False) - al_q * q)
        dk = rnd(att(q, mbd, True) - al_k * k)
        dqkv = torch.cat([dq, dk, dv], 1)
        du = _taps_pm(dqkv, taps3, n, h, w, transposed=True)
        rows_tq = _tap_rows(dqkv, u, n, h, w)

        def wrows(lhs, rhs, sa, sb):
            return [_mm(lhs[r0:r0 + ks].t(), rhs[r0:r0 + ks], sa, sb)
                    .reshape(-1) for r0 in range(0, p, ks)]

        dl = rnd(_mm(du, w_qkv.t(), nf, nf))
        gl = dl * scale
        dxl = rnd(rstd * (gl - gl.mean(1, keepdim=True)
                          - xh * (gl * xh).mean(1, keepdim=True)))
        dx[b0:b0 + n] = (dyp + dxl).reshape(n, h, w, c).permute(
            0, 3, 1, 2).to(dt)
        rows_ln = [torch.cat([(dl[i:i + 32] * xh[i:i + 32]).sum(0),
                              dl[i:i + 32].sum(0)]) for i in range(0, p, 32)]
        sl = torch.cat([
            _in_order(wrows(outf, dyp, sp, sp)),
            _in_order(wrows(out, duvf, sp, nf)),
            _in_order(rows_tv),
            _in_order(wrows(outs, d_out, sp, sp)),
            _in_order(wrows(ln, du, sp, nf)),
            _in_order(rows_tq),
            _in_order(rows_ln)])
        grads = sl if grads is None else grads + sl
    g_pof, g_kvf, g_tvf, g_po, g_qkv, g_t3, dsc, dbi = grads.split(
        (c * c, c * c, 9 * c, c * c, 3 * c * c, 27 * c, c, c))
    zero = torch.zeros(c, c)
    return (dx, dsc, dbi, g_qkv.view(c, 3 * c),
            g_t3.view(3 * c, 9).t().reshape(3, 3, 3 * c),
            dtemp.view(1, nh, 1, 1), g_po.view(c, c),
            torch.cat([zero, g_kvf.view(c, c)], 1),
            torch.cat([zero[:, :9], g_tvf.view(c, 9)]).t().reshape(
                3, 3, 2 * c),
            g_pof.view(c, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_kernel_algorithm(dtype):
    """Three images in two slices, 16 channels in two heads, 8 x 12 (96
    pixels: weight-gradient splits of 64 and dA splits of 32, ragged); f32
    within TOL of max(1, max|ref|), bf16 within 2e-2 of each gradient's
    max|ref| (the card's limit: the kernel rounds cotangents where the TPU
    kernel does, autograd through the plain version at other points)."""
    x, w = _case((3, 16, 8, 12), seed=6)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape), *w)]
    args[:2] = [t.to(dtype) for t in args[:2]]
    got = _emulate_backward(*args, NH, imgs=2)
    want = fused_mdta.ln_mdta_bwd_plain(*args, NH)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        if dtype == torch.float32:
            _close(g.numpy(), r.numpy())
        else:
            r = r.float()
            np.testing.assert_allclose(
                g.float().numpy(), r.numpy(), rtol=0,
                atol=2e-2 * float(r.abs().max()))


@pytest.mark.parametrize("batch", [8, 16], ids=["serve-b8", "train-b16"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_backward_plan_within_budget(batch, itemsize):
    """The backward's planner at every SpectralTransformer@256 block shape:
    the workspace within BWD_WORKSPACE_BYTES and equal to its mirror, the
    fewest slices that fit, the batch covered evenly, at most
    BWD_IMAGE_SPLITS dA rows an image, launch arguments aligned to the
    staged k depth; an image wider than the budget is a slice by itself."""
    for c, side in ((16, 256), (32, 128), (64, 64), (128, 32), (32, 256)):
        plan = fused_mdta.bwd_plan(batch, side, side, c, itemsize)
        assert plan.workspace <= fused_mdta.BWD_WORKSPACE_BYTES
        assert plan.workspace == fused_mdta.bwd_workspace_bytes(
            plan.imgs, side, side, c, itemsize, plan.split_pixels,
            plan.image_split_pixels)
        assert plan.imgs * plan.slices >= batch > plan.imgs * (
            plan.slices - 1)
        assert plan.launches == fused_mdta.BWD_LAUNCHES * plan.slices + 1
        assert plan.split_pixels % fused_mdta.BWD_K == 0
        assert plan.image_split_pixels % fused_mdta.BWD_K == 0
        assert -(-side * side // plan.image_split_pixels) <= \
            fused_mdta.BWD_IMAGE_SPLITS
        if plan.slices > 1:
            most = -(-batch // (plan.slices - 1))
            ks = fused_mdta.bwd_split_pixels(most * side * side, c, 132)
            assert fused_mdta.bwd_workspace_bytes(
                most, side, side, c, itemsize, ks,
                plan.image_split_pixels) > fused_mdta.BWD_WORKSPACE_BYTES
    big = fused_mdta.bwd_plan(2, 1024, 1024, 32, 2)
    assert big.imgs == 1 and big.slices == 2
    assert big.workspace > fused_mdta.BWD_WORKSPACE_BYTES


@pytest.mark.parametrize("batch", [8, 16], ids=["serve-b8", "train-b16"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_forward_plan_within_budget(batch, itemsize):
    """The forward's planner at every SpectralTransformer@256 block shape:
    the workspace within FWD_WORKSPACE_BYTES and equal to its mirror, the
    fewest slices that fit, the batch covered evenly, at most
    BWD_IMAGE_SPLITS gram rows an image on the staged k depth, the launches
    FWD_LAUNCHES a slice and one a call; an image wider than the budget is
    a slice by itself."""
    for c, side in ((16, 256), (32, 128), (64, 64), (128, 32), (32, 256)):
        plan = fused_mdta.fwd_plan(batch, side, side, c, itemsize)
        assert plan.workspace <= fused_mdta.FWD_WORKSPACE_BYTES
        assert plan.workspace == fused_mdta.fwd_workspace_bytes(
            plan.imgs, side, side, c, itemsize, plan.image_split_pixels)
        assert plan.imgs * plan.slices >= batch > plan.imgs * (
            plan.slices - 1)
        assert plan.launches == fused_mdta.FWD_LAUNCHES * plan.slices + 1
        assert plan.image_split_pixels % fused_mdta.BWD_K == 0
        assert -(-side * side // plan.image_split_pixels) <= \
            fused_mdta.BWD_IMAGE_SPLITS
        if plan.slices > 1:
            most = -(-batch // (plan.slices - 1))
            assert fused_mdta.fwd_workspace_bytes(
                most, side, side, c, itemsize,
                plan.image_split_pixels) > fused_mdta.FWD_WORKSPACE_BYTES
    big = fused_mdta.fwd_plan(2, 1024, 1024, 32, 2)
    assert big.imgs == 1 and big.slices == 2
    assert big.workspace > fused_mdta.FWD_WORKSPACE_BYTES


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
