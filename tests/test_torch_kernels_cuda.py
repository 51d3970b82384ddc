"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

- forward kernels: output vs the plain version on the same input;
- backward kernels: every gradient vs autograd through the plain version on
  the same input, dy and dtype, at one small and one ragged shape, the error
  over max|reference gradient|;
- gradients reach every parameter of a small model through the kernels
  (the autograd Functions), and the dead ones get exact zeros;
- the AST's kernels: LN+LeFF on channels-last tokens (with and without the
  residual, a per-image scale, ragged tiles) and window attention (dense
  and sparse, masked, N = 64/16/4) vs their plain versions, the window
  attention's kernel backward vs autograd through the plain version at
  the same four shapes (f32 and bf16, every gradient), two backward calls
  bit-equal and launching what their plan says, a bad backward launch and
  a window of more than 64 tokens refused;
- the LN+LeFF backward kernel vs autograd through the plain version (f32
  and bf16, with and without the residual, s with a zero, ragged edges, a
  hidden width that is not a multiple of 32, the widest AST level), two
  calls bit-equal, a refused launch raising, the LN+LeFF result carrying a
  ``grad_fn`` whose gradients reach every LeFF parameter, and a small AST's
  train-mode backward reaching every parameter through the kernels;
- the LN+MDTA and LN+GDFN forwards at ragged shapes and every tile shape,
  the LN+MDTA forward over forced slices (bit-equal to one slice), its
  stats against the plain version's gram and driving the backward, its
  split entries (stats and apply, the backward's two stages: what context
  parallelism runs around its sums) bit-equal to the whole-map entries on
  the whole map and against the plain halves on a band, the
  LN+GDFN forward with its hidden width split over blocks, two bf16 calls
  bit-equal;
- the window attention at the New* models' widest heads (d = 128, and 96,
  f32 and bf16): forward and backward vs the plain versions, two bf16
  backward calls bit-equal, d = 129 refused; a small NewModel's forward
  through the kernels, and its train-mode backward reaching every
  parameter, bit-equal over two bf16 passes;
- the staged designs' plans: the LN+LeFF forward and the LN+MDTA backward
  on both sides of their thresholds (one slice and several, forced by a
  smaller workspace budget; one and several dA ranges an image; 8, 16 and
  32 channels a head), each vs the plain version, launch counts as the
  planners say.
- the training run: two epochs of ``ModelTrainer.train`` through the
  kernels (a small SpectralTransformer, bf16, Adam, the watch on) equal
  one epoch and a resumed one bit for bit, with no cuDNN flag set by the
  test (the trainer sets it), also at ``steps_per_dispatch=2``;
- the K-step dispatch (``make_train_step(k_steps=2)``): a CUDA graph of the
  step replayed against eager steps for a small SpectralTransformer, a
  small AST with DropPath and the same AST with per-block remat, bit for
  bit (losses, grad norms, parameters, Adam's state, the generator), the
  kernels' tallies moving by one step's launches in the capture and not
  in the replays;
- every loss name's value and gradient on the card vs the CPU, and
  ``evaluate_pairs`` through the kernels vs the plain versions on a
  NewModel-Wavelet at 256x256;
- the four forward kernels as ``torch.library`` custom ops
  (``torch.ops.uir.ln_mdta``, ``ln_gdfn``, ``ln_leff``, ``window_attn``):
  each op's outputs equal the direct kernel call's bit for bit, with the
  same launches, and ``torch.library.opcheck`` passes (schema, fake
  implementation, autograd registration, AOT dispatch); a small
  SpectralTransformer exported on the card runs the kernels, and the model
  takes a strided (permuted NHWC) input.

These need the card (a CUDA kernel has no CPU mode) and skip without one.
The file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Shapes leave ragged tiles at the bottom and right edges (20 x 36) and use
two heads.  As in ``chip_smoke.py``, the plain version runs on the same
input and dtype, the weights keep every 1x1 and 3x3 at unit variance (with
a peaked softmax and a scaled project_outf) so the branch y - x is O(1), and
the error is scaled by max|branch|: f32 5e-5, bf16 2e-2.  A kernel that
dropped the branch would score 1.  TF32 is off, or the plain version's f32
convolutions would round their inputs to 10 mantissa bits.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops import (
    _kernels,
    fused_gdfn,
    fused_leff,
    fused_mdta,
    window_attention,
    window_attention_plain,
)
from underwater_image_restoration_torch.ops.windows import shift_mask

# the module (``ops.window_attention`` is also the name of its function)
wa = importlib.import_module(
    "underwater_image_restoration_torch.ops.window_attention")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _weights(kind, c, nh, rng):
    def n(fan_in, *shape):
        return (rng.standard_normal(shape) / fan_in ** 0.5).astype(np.float32)

    ln = (1 + 0.1 * n(1, c), 0.1 * n(1, c))
    if kind == "gdfn":
        hid = int(c * 2.66)
        return ln + (n(c, c, 2 * hid), n(9, 3, 3, 2 * hid), n(hid, hid, c))
    return ln + (n(c, c, 3 * c), n(9, 3, 3, 3 * c),
                 16 * (1 + 0.2 * n(1, 1, nh, 1, 1)), n(c, c, c),
                 n(c, c, 2 * c), n(9, 3, 3, 2 * c), 4 * n(c, c, c))


FWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _fwd_case(kind, shape, nh, dtype, cuda, seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = [torch.from_numpy(a).to(cuda)
         for a in _weights(kind, shape[1], nh, rng)]
    return x.to(cuda, dtype), w


def _fwd(kind, x, w, nh, plain=False):
    if kind == "gdfn":
        fn = fused_gdfn.ln_gdfn_plain if plain else fused_gdfn.ln_gdfn
        return fn(x, *w)
    fn = fused_mdta.ln_mdta_plain if plain else fused_mdta.ln_mdta
    return fn(x, *w, nh)


def _branch_err(got, want, x):
    """max abs error over max|branch| (y - x)."""
    err = (got.float() - want.float()).abs().max().item()
    return err / (want.float() - x.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gdfn", "mdta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, nh", [
    ((2, 32, 20, 36), 2), ((3, 16, 21, 70), 2), ((2, 64, 24, 40), 2),
    ((2, 128, 12, 20), 8)],
    ids=["C32-20x36", "C16-21x70", "C64-cph32", "C128-12x20"])
def test_kernel_matches_plain(cuda, kind, dtype, shape, nh):
    """Ragged tiles at the bottom and right edges at every tile shape, 8, 16
    and 32 channels a head, a 70-pixel row (two segments of the MDTA taps
    passes) and a gram over more than one pixel range (21 x 70)."""
    x, w = _fwd_case(kind, shape, nh, dtype, cuda)
    got, want = _fwd(kind, x, w, nh), _fwd(kind, x, w, nh, plain=True)
    torch.cuda.synchronize()
    assert _branch_err(got, want, x) <= FWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mdta_forward_slices(cuda, dtype, monkeypatch):
    """The staged forward over three slices of one image (a budget of one
    image's workspace) gives the bits of one slice of three, y and stats:
    no reduction crosses the slices; both match the plain version;
    FWD_LAUNCHES a slice and one a call."""
    b, c, h, w_, nh = 3, 32, 12, 20, 2
    x, w = _fwd_case("mdta", (b, c, h, w_), nh, dtype, cuda, seed=41)
    one = fused_mdta.fwd_plan(b, h, w_, c, x.element_size())
    assert one.slices == 1
    whole, st_whole = fused_mdta.forward_with_stats(x, *w, nh)
    monkeypatch.setattr(fused_mdta, "FWD_WORKSPACE_BYTES",
                        fused_mdta.fwd_workspace_bytes(
                            1, h, w_, c, x.element_size(),
                            one.image_split_pixels))
    assert fused_mdta.fwd_plan(b, h, w_, c, x.element_size()).slices == 3
    fused_mdta.ln_mdta.launches.clear()
    sliced, st_sliced = fused_mdta.forward_with_stats(x, *w, nh)
    want = fused_mdta.ln_mdta_plain(x, *w, nh)
    torch.cuda.synchronize()
    assert fused_mdta.ln_mdta.launches[(c, h, w_)] == \
        3 * fused_mdta.FWD_LAUNCHES + 1
    assert torch.equal(sliced, whole) and torch.equal(st_sliced, st_whole)
    assert _branch_err(sliced, want, x) <= FWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 7])
def test_gdfn_forward_splits(cuda, dtype, splits, monkeypatch):
    """The forward with the hidden width (85, padded to 96: 6 chunks) split
    over 1, 2 and 7 (refused: more than one a chunk) blocks a tile, against
    the plain version; two launches unsplit (the weights' operands, the
    tiles), three split (and the splits' sum)."""
    x, w = _fwd_case("gdfn", (2, 32, 20, 36), 1, dtype, cuda, seed=43)
    monkeypatch.setattr(fused_gdfn, "fwd_splits", lambda *a: splits)
    fused_gdfn.ln_gdfn.launches.clear()
    if splits > 6:
        with pytest.raises(RuntimeError, match="ln_gdfn"):
            fused_gdfn.ln_gdfn(x, *w)
        return
    got = fused_gdfn.ln_gdfn(x, *w)
    want = fused_gdfn.ln_gdfn_plain(x, *w)
    torch.cuda.synchronize()
    assert fused_gdfn.ln_gdfn.launches[(32, 20, 36)] == (
        2 if splits == 1 else 3)
    assert _branch_err(got, want, x) <= FWD_TOL[dtype]


@pytest.mark.cuda
def test_gdfn_weight_operands(cuda):
    """The forward's weight operands, made on the card, are kernel_operands'
    (the chunk layout, the zero-padded hidden width, the bf16 hi/lo planes)
    bit for bit, at hidden widths 42 and 340, from contiguous weights and
    from transposed views (as the model passes its conv weights: each
    copy must live until the kernel has read it)."""
    for c in (16, 128):
        x, w = _fwd_case("gdfn", (1, c, 8, 8), 1, torch.float32, cuda)
        views = [t.t().contiguous().t() if t.dim() == 2 else t for t in w]
        assert not views[2].is_contiguous()
        want = fused_gdfn.kernel_operands(*w[2:])
        for ws in (w, views):
            _, got = fused_gdfn._forward_cuda(x, *ws, 1e-5)
            assert got.hid_pad == want.hid_pad
            for a, b in zip(got[:5], want[:5]):
                assert torch.equal(a.reshape(-1), b.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gdfn", "mdta"])
def test_forward_bit_equal(cuda, kind):
    """Two bf16 forward calls give the same bits (and, for LN+MDTA, the
    same stats): every sum in a fixed order, no float atomics, no ticket."""
    x, w = _fwd_case(kind, (3, 64, 21, 70), 4, torch.bfloat16, cuda, 47)
    if kind == "gdfn":
        a, b = fused_gdfn.ln_gdfn(x, *w), fused_gdfn.ln_gdfn(x, *w)
        assert torch.equal(a, b)
    else:
        a, b = (fused_mdta.forward_with_stats(x, *w, 4) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mdta_forward_stats(cuda, dtype):
    """The forward's stats (each image's gram within the heads, Sq and Sk
    of round(q) and round(k)) against the plain version's own q and k, and
    the backward fed them against autograd through the plain version,
    within the backward's limits."""
    b, c, h, w_, nh = 2, 32, 48, 64, 2  # 3072 pixels: two gram ranges
    x, w = _fwd_case("mdta", (b, c, h, w_), nh, dtype, cuda, seed=53)
    _, stats = fused_mdta.forward_with_stats(x, *w, nh)
    cph = c // nh
    ln = fused_mdta.layer_norm_channels(x, w[0], w[1]).float()
    qk = fused_mdta.dwconv3x3(fused_mdta.conv1x1(ln, w[2][:, :2 * c]),
                              w[3][:, :, :2 * c]).to(dtype).float()
    q = qk[:, :c].reshape(b, nh, cph, h * w_)
    k = qk[:, c:].reshape(b, nh, cph, h * w_)
    ref = torch.cat([torch.einsum("bhil,bhjl->bhij", q, k).reshape(b, -1),
                     q.square().sum(-1).reshape(b, c),
                     k.square().sum(-1).reshape(b, c)], 1).reshape(-1)
    torch.cuda.synchronize()
    # f32: sums in another order; bf16: a q or k value on the other side of
    # a rounding boundary moves its entries by a bf16 ulp of it
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (stats - ref).abs().max() <= tol * ref.abs().max()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    dy = dy.to(cuda, dtype)
    got = fused_mdta.ln_mdta_bwd(x, dy, *w, nh, stats=stats)
    want = fused_mdta.ln_mdta_bwd_plain(x, dy, *w, nh)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, want)):
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (i, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("budget", [None, 1 << 20])
def test_mdta_split_entries_bit_equal(cuda, dtype, budget, monkeypatch):
    """The split forward (stats over every row, then apply) and the split
    backward (stage 1, stage 2, no sum between) on the whole map give the
    whole-map entries' bits, in one slice and in several (a smaller
    workspace budget), launching what their plans say."""
    if budget is not None:
        monkeypatch.setattr(fused_mdta, "FWD_WORKSPACE_BYTES", budget)
        monkeypatch.setattr(fused_mdta, "BWD_WORKSPACE_BYTES", budget)
    b, c, h, w_, nh = 3, 32, 20, 36, 2
    x, w = _fwd_case("mdta", (b, c, h, w_), nh, dtype, cuda, seed=61)
    y, stats = fused_mdta.forward_with_stats(x, *w, nh)
    for cnt in (fused_mdta.ln_mdta_stats.launches,
                fused_mdta.ln_mdta_apply.launches,
                fused_mdta.ln_mdta_bwd_stage1.launches,
                fused_mdta.ln_mdta_bwd_stage2.launches):
        cnt.clear()
    st = fused_mdta.ln_mdta_stats(x, *w, nh, 0, h)
    y2 = fused_mdta.ln_mdta_apply(x, *w, nh, st)
    torch.cuda.synchronize()
    assert torch.equal(st.reshape(-1), stats) and torch.equal(y2, y)
    plan = fused_mdta.fwd_plan(b, h, w_, c, x.element_size())
    assert plan.slices > 1 if budget else plan.slices == 1
    assert fused_mdta.ln_mdta_stats.launches[(c, h, w_)] == \
        1 + fused_mdta.FWD_STATS_LAUNCHES * plan.slices
    assert fused_mdta.ln_mdta_apply.launches[(c, h, w_)] == \
        1 + fused_mdta.FWD_APPLY_LAUNCHES * plan.slices
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    dy = dy.to(cuda, dtype)
    want = fused_mdta.ln_mdta_bwd(x, dy, *w, nh, stats=stats)
    got = fused_mdta.ln_mdta_bwd_rows(x, dy, *w, nh, stats.view(b, -1), 0,
                                      h)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, want)):
        assert torch.equal(g, r), i
    bp = fused_mdta.bwd_plan(b, h, w_, c, x.element_size(),
                             _kernels.sm_count(x.device))
    assert bp.slices > 1 if budget else bp.slices == 1
    assert fused_mdta.ln_mdta_bwd_stage1.launches[(c, h, w_)] == \
        fused_mdta.BWD_STAGE1_LAUNCHES * bp.slices
    assert fused_mdta.ln_mdta_bwd_stage2.launches[(c, h, w_)] == \
        fused_mdta.BWD_STAGE2_LAUNCHES * bp.slices


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mdta_split_entries_on_a_band(cuda, dtype):
    """On a band with two halo rows each side (rows [2, 18) of 20 hold the
    stats): the stats, apply and the split backward (dy zero on the halo,
    one rank, so the sum is the rank's own) against the plain halves
    composed by autograd, within the whole-map kernels' limits: dq and dk
    masked to the band's rows, dtemp taken once."""
    b, c, h, w_, nh, r0, r1 = 2, 32, 20, 36, 2, 2, 18
    x, w = _fwd_case("mdta", (b, c, h, w_), nh, dtype, cuda, seed=67)
    st = fused_mdta.ln_mdta_stats(x, *w, nh, r0, r1)
    ref = fused_mdta.ln_mdta_stats_plain(x, *w[:4], nh, r0, r1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (st - ref).abs().max() <= tol * ref.abs().max()
    y = fused_mdta.ln_mdta_apply(x, *w, nh, st)
    want = fused_mdta.ln_mdta_apply_plain(x, st, *w, nh)
    assert _branch_err(y, want, x) <= FWD_TOL[dtype]
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    dy[:, :, :r0] = 0
    dy[:, :, r1:] = 0
    dy = dy.to(cuda, dtype)
    got = fused_mdta.ln_mdta_bwd_rows(x, dy, *w, nh, st, r0, r1)
    ins = [t.detach().requires_grad_() for t in (x, *w)]
    with torch.enable_grad():
        out = fused_mdta.ln_mdta_apply_plain(
            ins[0], fused_mdta.ln_mdta_stats_plain(ins[0], *ins[1:5], nh,
                                                   r0, r1), *ins[1:], nh)
        want = torch.autograd.grad(out, ins, dy)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, want)):
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (i, err, scale)


@pytest.mark.cuda
def test_gdfn_refuses_another_gate_chunk(cuda, monkeypatch):
    """The weight layout's chunk size travels with the launch; a kernel
    built for another one refuses it (hidden width 42 pads to 48 either
    way, so only that check can catch it)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        rng.standard_normal((1, 16, 8, 8)).astype(np.float32)).to(cuda)
    w = [torch.from_numpy(a).to(cuda) for a in _weights("gdfn", 16, 1, rng)]
    monkeypatch.setattr(fused_gdfn, "GATE_CHUNK", 8)
    with pytest.raises(RuntimeError, match="ln_gdfn"):
        fused_gdfn.ln_gdfn(x, *w)


# backward kernels vs autograd through the plain version, max abs error over
# max|reference gradient|, per gradient tensor (chip_smoke.py's limits)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gdfn", "mdta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (2, 32, 20, 36),
                                   (2, 128, 32, 32)],
                         ids=["16x16", "ragged-20x36", "C128-32x32"])
def test_backward_kernel_matches_plain(cuda, kind, dtype, shape):
    """Hidden widths 42, 85 and 340 are not multiples of GATE_CHUNK; C = 128
    at 32x32 is the widest Spectral block.  A second call gives bit-equal
    gradients (per-block rows summed in order, no float atomics)."""
    rng = np.random.default_rng(11)
    c = shape[1]
    nh = max(2, c // 16)  # the model's 8 heads at C = 128
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, dy = x.to(cuda, dtype), dy.to(cuda, dtype)
    w = [torch.from_numpy(a).to(cuda) for a in _weights(kind, c, nh, rng)]
    if kind == "gdfn":
        def kern():
            return fused_gdfn.ln_gdfn_bwd(x, dy, *w)
        want = fused_gdfn.ln_gdfn_bwd_plain(x, dy, *w)
    else:
        stats = fused_mdta.forward_with_stats(x, *w, nh)[1]

        def kern():
            return fused_mdta.ln_mdta_bwd(x, dy, *w, nh, stats=stats)
        want = fused_mdta.ln_mdta_bwd_plain(x, dy, *w, nh)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape, i
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (i, err, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["leff", "gdfn", "mdta", "leff-fwd",
                                  "gdfn-fwd", "mdta-fwd"])
def test_backward_refuses_a_bad_launch(cuda, kind, monkeypatch):
    """A launch the kernel refuses (here: a weight-gradient split or a gram
    range that is not a multiple of the staged k depth, a tile too wide for
    the tensor-core steps or not a whole number of them, or a hidden width
    that is no whole number of k16 steps) raises instead of leaving its
    outputs unwritten."""
    rng = np.random.default_rng(23)
    if kind == "mdta-fwd":
        x = torch.from_numpy(rng.standard_normal((1, 16, 8, 8)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda)
             for a in _weights("mdta", 16, 2, rng)]
        monkeypatch.setattr(fused_mdta, "bwd_image_split_pixels",
                            lambda *a: fused_mdta.BWD_K + 1)
        with pytest.raises(RuntimeError, match="ln_mdta"):
            fused_mdta.ln_mdta(x, *w, 2)
    elif kind == "gdfn-fwd":
        x = torch.from_numpy(rng.standard_normal((1, 16, 8, 8)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda)
             for a in _weights("gdfn", 16, 1, rng)]
        monkeypatch.setattr(fused_gdfn, "fwd_tile_shape", lambda *a: (4, 6))
        with pytest.raises(RuntimeError, match="ln_gdfn"):
            fused_gdfn.ln_gdfn(x, *w)
    elif kind == "mdta":
        x = torch.from_numpy(rng.standard_normal((1, 16, 8, 8)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda)
             for a in _weights("mdta", 16, 2, rng)]
        stats = fused_mdta.forward_with_stats(x, *w, 2)[1]
        monkeypatch.setattr(fused_mdta, "bwd_split_pixels",
                            lambda *a: fused_mdta.BWD_K + 1)
        with pytest.raises(RuntimeError, match="ln_mdta_bwd"):
            fused_mdta.ln_mdta_bwd(x, x, *w, 2, stats=stats)
    elif kind == "leff-fwd":
        c, hid = 8, 36
        x = torch.from_numpy(rng.standard_normal((1, 8, 8, c)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda) for a in (
            np.ones(c, np.float32), np.zeros(c, np.float32),
            rng.standard_normal((c, hid)).astype(np.float32),
            np.zeros(hid, np.float32),
            rng.standard_normal((3, 3, hid)).astype(np.float32),
            np.zeros(hid, np.float32),
            rng.standard_normal((hid, c)).astype(np.float32),
            np.zeros(c, np.float32))]
        monkeypatch.setattr(fused_leff, "HIDDEN_CHUNK", 4)  # 36 stays 36
        with pytest.raises(RuntimeError, match="ln_leff"):
            fused_leff.ln_leff(x, *w)
    elif kind == "leff":
        c, hid = 8, 32
        x = torch.from_numpy(rng.standard_normal((1, 8, 8, c)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda) for a in (
            np.ones(c, np.float32), np.zeros(c, np.float32),
            rng.standard_normal((c, hid)).astype(np.float32),
            np.zeros(hid, np.float32),
            rng.standard_normal((3, 3, hid)).astype(np.float32),
            np.zeros(hid, np.float32),
            rng.standard_normal((hid, c)).astype(np.float32),
            np.zeros(c, np.float32))]
        monkeypatch.setattr(fused_leff, "bwd_split_pixels",
                            lambda *a: fused_leff.BWD_K + 1)
        with pytest.raises(RuntimeError, match="ln_leff_bwd"):
            fused_leff.ln_leff_bwd(x, x, *w)
    else:
        x = torch.from_numpy(rng.standard_normal((1, 16, 8, 8)).astype(
            np.float32)).to(cuda)
        w = [torch.from_numpy(a).to(cuda)
             for a in _weights("gdfn", 16, 1, rng)]
        monkeypatch.setattr(fused_gdfn, "bwd_tile_shape", lambda *a: (8, 6))
        with pytest.raises(RuntimeError, match="ln_gdfn_bwd"):
            fused_gdfn.ln_gdfn_bwd(x, x, *w)


@pytest.mark.cuda
def test_model_gradients_reach_every_parameter(cuda):
    """One backward() through a small model on the card: every parameter
    the forward uses gets a finite gradient through the kernels' autograd
    Functions (a result detached from its inputs would leave None upstream
    of the last block), and the dead ones (q1X1_1, the kf half of kv and
    kv_conv) stay unused."""
    model = init_model("SpectralTransformer", device=cuda, seed=2,
                       channels=(16, 32, 64, 128), num_blocks=(1, 1, 1, 1),
                       num_refinement=1)
    fused_gdfn.ln_gdfn_bwd.launches.clear()
    fused_mdta.ln_mdta.launches.clear()
    fused_mdta.ln_mdta_bwd.launches.clear()
    x = torch.rand(2, 3, 32, 32, device=cuda) * 2 - 1
    model(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert sum(fused_gdfn.ln_gdfn_bwd.launches.values()) == 2 * 8
    # a block's forward and backward: FWD_LAUNCHES and BWD_LAUNCHES a slice
    # of the batch and one a call (fwd_plan, bwd_plan)
    blocks = {}
    for (c, h, w), n in fused_mdta.ln_mdta.launches.items():
        per = fused_mdta.fwd_plan(2, h, w, c, 4).launches
        assert n % per == 0
        blocks[(c, h, w)] = n // per
    assert sum(blocks.values()) == 8
    assert fused_mdta.ln_mdta_bwd.launches == {
        (c, h, w): n * fused_mdta.bwd_plan(2, h, w, c, 4).launches
        for (c, h, w), n in blocks.items()}
    for name, p in model.named_parameters():
        if "q1X1_1" in name:
            assert p.grad is None, name
            continue
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        if ".kv." in name or ".kv_conv." in name:
            c = p.shape[0] // 2
            assert torch.count_nonzero(p.grad[:c]) == 0, name
            assert torch.count_nonzero(p.grad[c:]) > 0, name
        else:
            assert torch.count_nonzero(p.grad) > 0, name


# the AST's kernels, with chip_smoke.py's limits: error over max|branch|
AST_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _leff_weights(c, rng):
    def n(fan_in, *shape):
        return (rng.standard_normal(shape) / fan_in ** 0.5).astype(np.float32)

    hid = 4 * c
    return (1 + 0.1 * n(1, c), 0.1 * n(1, c), n(c, c, hid), 0.1 * n(1, hid),
            n(9, 3, 3, hid), 0.1 * n(1, hid), n(hid, hid, c), 0.1 * n(1, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, residual", [((2, 20, 36, 8), True),
                                             ((2, 16, 16, 64), False),
                                             ((2, 10, 12, 512), False)],
                         ids=["ragged-C8", "C64-branch", "C512-branch"])
def test_leff_kernel_matches_plain(cuda, dtype, shape, residual):
    """The staged forward at a ragged C = 8 shape (hidden 32) and, without
    the residual, with a per-image scale s (the New* encoders' call) at
    C = 64 and at the widest AST level, C = 512 (hidden 2048)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(cuda, dtype)
    w = [torch.from_numpy(a).to(cuda) for a in _leff_weights(shape[-1], rng)]
    s = torch.tensor([1.0, 0.5], device=cuda)
    got = fused_leff.ln_leff(x, *w, s=s, residual=residual)
    want = fused_leff.ln_leff_plain(x, *w, s=s, residual=residual)
    torch.cuda.synchronize()
    branch = (want.float() - (x.float() if residual else 0)).abs().max()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= AST_TOL[dtype] * branch.item()


@pytest.mark.cuda
def test_leff_refuses_inputs_that_need_gradients(cuda):
    """Once the LN+LeFF route refused inputs that need a gradient (it had no
    backward kernel); now its CUDA result carries a ``grad_fn`` (LnLeffFn),
    and ``.grad`` reaches the LayerNorm's and every LeFF parameter through
    the views ``LeFF.operands()`` passes, close to the plain version's."""
    from underwater_image_restoration_torch.models.blocks import LeFF
    from underwater_image_restoration_torch.ops.layers import TokenLayerNorm

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(
        np.float32)).to(cuda)
    grads = {}
    for route in (fused_leff.ln_leff, fused_leff.ln_leff_plain):
        torch.manual_seed(0)
        norm, leff = TokenLayerNorm(16, device=cuda), LeFF(16, 64, device=cuda)
        y = route(x, norm.weight, norm.bias, *leff.operands())
        assert y.grad_fn is not None
        y.square().sum().backward()
        grads[route] = {n: p.grad for m in (norm, leff)
                        for n, p in m.named_parameters()}
    torch.cuda.synchronize()
    got, want = grads[fused_leff.ln_leff], grads[fused_leff.ln_leff_plain]
    assert len(got) == 8
    for name, g in got.items():
        assert g is not None and torch.isfinite(g).all(), name
        assert torch.count_nonzero(g) > 0, name
        err = (g - want[name]).abs().max().item()
        assert err <= BWD_TOL[torch.float32] * want[name].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, hid, residual", [
    ((2, 20, 36, 8), 40, True), ((2, 20, 36, 8), 32, False),
    ((2, 12, 12, 64), 256, True), ((2, 16, 16, 512), 2048, True)],
    ids=["ragged-C8-hid40", "ragged-C8-branch", "C64", "C512-hid2048"])
def test_leff_backward_kernel_matches_plain(cuda, dtype, shape, hid,
                                            residual):
    """Hidden 40 pads to 64; C = 512 at 16x16 with hidden 2048 is the
    widest AST level.  A second call gives bit-equal gradients."""
    rng = np.random.default_rng(19)
    c = shape[-1]

    def n(fan_in, *sh):
        return torch.from_numpy((rng.standard_normal(sh) / fan_in ** 0.5)
                                .astype(np.float32)).to(cuda)

    x, dy = n(1, *shape).to(dtype), n(1, *shape).to(dtype)
    w = [1 + 0.1 * n(1, c), 0.1 * n(1, c), n(c, c, hid), 0.1 * n(1, hid),
         n(9, 3, 3, hid), 0.1 * n(1, hid), n(hid, hid, c), 0.1 * n(1, c)]
    s = torch.tensor([1.25, 0.0], device=cuda)
    got = fused_leff.ln_leff_bwd(x, dy, *w, s=s, residual=residual)
    again = fused_leff.ln_leff_bwd(x, dy, *w, s=s, residual=residual)
    want = fused_leff.ln_leff_bwd_plain(x, dy, *w, s=s, residual=residual)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 9
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape and torch.isfinite(g).all(), i
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (i, err, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _attn_inputs(cuda, dtype, nw, heads, ws, d, masked, sparse, seed):
    rng = np.random.default_rng(seed)
    n = ws * ws
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2 * nw, heads, n, d)).astype(np.float32)).to(cuda, dtype)
        for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n)).astype(
        np.float32)).to(cuda)
    side = ws * int(nw ** 0.5)
    mask = shift_mask(side, side, ws, ws // 2, cuda) if masked else None
    w = torch.tensor([0.3, -0.4], device=cuda) if sparse else None
    return q, k, v, bias, w, mask, d ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw, heads, ws, d, masked, sparse", [
    (4, 4, 8, 32, True, True), (4, 2, 4, 8, False, True),
    (1, 16, 2, 8, False, False), (16, 2, 4, 64, True, False)],
    ids=["N64-masked-sparse", "N16-sparse", "N4-dense", "N16-d64-masked"])
def test_window_attn_kernel_matches_plain(cuda, dtype, nw, heads, ws, d,
                                          masked, sparse):
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, dtype, nw, heads, ws, d, masked, sparse, 15)
    got = window_attention(q, k, v, bias, scale=scale, sparse_w=w,
                           mask=mask)
    want = window_attention_plain(q, k, v, bias, scale=scale, sparse_w=w,
                                  mask=mask)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= AST_TOL[dtype] * want.float().abs().max().item()


ATTN_SHAPES = [(4, 4, 8, 32, True, True), (4, 2, 4, 8, False, True),
               (1, 16, 2, 8, False, False), (16, 2, 4, 64, True, False)]
ATTN_IDS = ["N64-masked-sparse", "N16-sparse", "N4-dense", "N16-d64-masked"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw, heads, ws, d, masked, sparse", ATTN_SHAPES,
                         ids=ATTN_IDS)
def test_window_attn_backward_matches_plain(cuda, dtype, nw, heads, ws, d,
                                            masked, sparse):
    """dq, dk, dv, dbias (and dw when sparse) through WindowAttnFn, whose
    backward is csrc/window_attn_bwd.cu, vs autograd through the plain
    version, each gradient's max abs error over its max|ref|: f32 1e-4,
    bf16 2e-2 (BWD_TOL); the kernel backward launched, the plain recompute
    not called."""
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, dtype, nw, heads, ws, d, masked, sparse, 16)
    ins = [t.detach().requires_grad_() for t in (q, k, v, bias, w)
           if t is not None]
    g = torch.randn_like(q)
    wa.window_attn_bwd.launches.clear()
    kw = dict(scale=scale, sparse_w=ins[4] if sparse else None, mask=mask)
    got = torch.autograd.grad(window_attention(*ins[:4], **kw), ins, g)
    want = torch.autograd.grad(window_attention_plain(*ins[:4], **kw), ins, g)
    torch.cuda.synchronize()
    assert sum(wa.window_attn_bwd.launches.values()) == 2 + sparse
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert torch.isfinite(a).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attn_backward_bit_equal_and_planned(cuda, dtype):
    """Two backward calls give the same bits (dbias and dw summed in block
    order, no float atomics), and a call launches what its plan says: the
    kernel, reduce_rows for dbias and the dw step, or fewer when fewer
    gradients are wanted."""
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, dtype, 16, 2, 8, 32, True, True, 18)
    g = torch.randn_like(q)
    kw = dict(scale=scale, sparse_w=w, mask=mask)
    wa.window_attn_bwd.launches.clear()
    one = wa.window_attn_bwd(g, q, k, v, bias, **kw)
    two = wa.window_attn_bwd(g, q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    plan = wa.bwd_plan(q.shape[0], 2, 64, _kernels.sm_count(q.device),
                       d=32, itemsize=q.element_size())
    assert plan.blocks_per_head > 1
    assert wa.window_attn_bwd.launches == {(32, 2, 64, 32, True):
                                           2 * plan.launches}
    part = wa.window_attn_bwd(g, q, k, v, bias, **kw,
                              need=(True, False, True, False, False))
    assert part[1] is None and part[3] is None and part[4] is None
    assert torch.equal(part[0], one[0]) and torch.equal(part[2], one[2])
    assert wa.window_attn_bwd.launches[(32, 2, 64, 32, True)] == \
        2 * plan.launches + 1


@pytest.mark.cuda
def test_window_attn_backward_refuses_bad_launch(cuda, monkeypatch):
    """A cotangent of another shape raises before the launch; a launch the
    kernel refuses (no windows a block) raises with the CUDA error."""
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, torch.float32, 4, 2, 4, 8, True, True, 19)
    with pytest.raises(ValueError, match="g must match q"):
        wa.window_attn_bwd(q[:1], q, k, v, bias, scale=scale, sparse_w=w,
                           mask=mask)
    monkeypatch.setattr(wa, "bwd_plan",
                        lambda *a, **k: wa.Plan(1, 0, 0, 3))
    with pytest.raises(RuntimeError, match="window_attn_bwd: CUDA error"):
        wa.window_attn_bwd(q, q, k, v, bias, scale=scale, sparse_w=w,
                           mask=mask)


def _leff_fwd_launches(seen, batch, itemsize):
    """The LN+LeFF forward's launches by (C, H, W) for the shapes in
    ``seen``: two calls a level (18 in all), fwd_plan's launches each."""
    assert len(seen) == 9
    return {(c, h, w): 2 * fused_leff.fwd_plan(batch, h, w, c, 4 * c,
                                               itemsize).launches
            for c, h, w in seen}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leff_forward_slices(cuda, dtype, monkeypatch):
    """The staged forward over three slices of one image (a budget below
    two images' workspace) gives the bits of one slice of three: no
    reduction crosses the slices; both match the plain version, with
    residual=False and s holding a zero."""
    rng = np.random.default_rng(29)
    c = 32
    x = torch.from_numpy(rng.standard_normal((3, 12, 20, c)).astype(
        np.float32)).to(cuda, dtype)
    w = [torch.from_numpy(a).to(cuda) for a in _leff_weights(c, rng)]
    s = torch.tensor([1.25, 0.0, 0.5], device=cuda)
    one = fused_leff.fwd_plan(3, 12, 20, c, 4 * c, x.element_size())
    assert one.slices == 1
    whole = fused_leff.ln_leff(x, *w, s=s, residual=False)
    monkeypatch.setattr(fused_leff, "FWD_WORKSPACE_BYTES",
                        fused_leff.fwd_workspace_bytes(
                            1, 12, 20, c, 4 * c, x.element_size()))
    assert fused_leff.fwd_plan(3, 12, 20, c, 4 * c,
                               x.element_size()).slices == 3
    fused_leff.ln_leff.launches.clear()
    sliced = fused_leff.ln_leff(x, *w, s=s, residual=False)
    want = fused_leff.ln_leff_plain(x, *w, s=s, residual=False)
    torch.cuda.synchronize()
    assert fused_leff.ln_leff.launches[(c, 12, 20)] == \
        3 * fused_leff.FWD_LAUNCHES
    assert torch.equal(sliced, whole) and not sliced[1].any()
    err = (sliced.float() - want.float()).abs().max().item()
    assert err <= AST_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, c, h, w, nh, slices", [
    (3, 32, 48, 64, 1, 1), (3, 16, 21, 70, 2, 3), (2, 64, 12, 20, 8, 2)],
    ids=["cph32-two-dA-ranges", "cph8-ragged-3-slices", "cph8-C64-2-slices"])
def test_mdta_backward_plan_thresholds(cuda, dtype, b, c, h, w, nh, slices,
                                       monkeypatch):
    """The LN+MDTA backward on both sides of its plan's thresholds: 32
    channels a head with 3072 pixels an image (two dA ranges), and 8 a head
    over ragged images (21 x 70: a second column segment in the taps
    passes) walked in several slices (a workspace budget of one or two
    images forces them); every gradient vs autograd through the
    plain version, two calls bit-equal, BWD_LAUNCHES a slice and one a
    call."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to(cuda, dtype)
    dy = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to(cuda, dtype)
    ws = [torch.from_numpy(a).to(cuda) for a in _weights("mdta", c, nh, rng)]
    if slices > 1:
        imgs = -(-b // slices)
        ks = fused_mdta.bwd_split_pixels(imgs * h * w, c, 132)
        monkeypatch.setattr(fused_mdta, "BWD_WORKSPACE_BYTES",
                            fused_mdta.bwd_workspace_bytes(
                                imgs, h, w, c, x.element_size(), ks,
                                fused_mdta.bwd_image_split_pixels(h * w)))
    plan = fused_mdta.bwd_plan(b, h, w, c, x.element_size())
    assert plan.slices == slices
    assert (-(-h * w // plan.image_split_pixels) > 1) == (h * w > 2048)
    stats = fused_mdta.forward_with_stats(x, *ws, nh)[1]
    fused_mdta.ln_mdta_bwd.launches.clear()
    got = fused_mdta.ln_mdta_bwd(x, dy, *ws, nh, stats=stats)
    again = fused_mdta.ln_mdta_bwd(x, dy, *ws, nh, stats=stats)
    want = fused_mdta.ln_mdta_bwd_plain(x, dy, *ws, nh)
    torch.cuda.synchronize()
    assert fused_mdta.ln_mdta_bwd.launches[(c, h, w)] == \
        2 * (fused_mdta.BWD_LAUNCHES * slices + 1) == 2 * plan.launches
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape and torch.isfinite(g).all(), i
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (i, err, scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
def test_ast_forward_goes_through_the_kernels(cuda):
    """A small AST on the card: 18 LN+LeFF calls (FWD_LAUNCHES a slice of
    the batch each, fwd_plan) and 10 window-attention launches (3 masked at
    32x32 with window 4: the levels at 8x8 and up), output close to the
    plain versions' in f32."""
    model = init_model("AST", device=cuda, seed=3, img_size=32, embed_dim=8,
                       win_size=4)
    fused_leff.ln_leff.launches.clear()
    window_attention.launches.clear()
    x = torch.rand(2, 3, 32, 32, device=cuda) * 2 - 1
    with torch.no_grad():
        got = model(x)
        want = model(x, use_kernels=False)
    torch.cuda.synchronize()
    assert fused_leff.ln_leff.launches == _leff_fwd_launches(
        fused_leff.ln_leff.launches, 2, 4)
    assert sum(window_attention.launches.values()) == 10
    assert sum(n for k, n in window_attention.launches.items() if k[4]) == 3
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_ast_gradients_reach_every_parameter(cuda):
    """A small AST's train-mode backward on the card (DropPath at rate 0, so
    every branch counts): 18 LN+LeFF forward calls (one slice of
    FWD_LAUNCHES launches each) and 18 backward calls (one slice of
    BWD_LAUNCHES each), 10 window attentions forward and 10 kernel
    backwards (3 masked; dbias and dw wanted, so three launches each),
    every parameter's gradient finite and non-zero."""
    model = init_model("AST", device=cuda, seed=4, img_size=32, embed_dim=8,
                       win_size=4, drop_path_rate=0.0).train()
    fused_leff.ln_leff.launches.clear()
    fused_leff.ln_leff_bwd.launches.clear()
    window_attention.launches.clear()
    wa.window_attn_bwd.launches.clear()
    x = torch.rand(2, 3, 32, 32, device=cuda) * 2 - 1
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    assert fused_leff.ln_leff.launches == _leff_fwd_launches(
        fused_leff.ln_leff.launches, 2, 4)
    assert sum(fused_leff.ln_leff_bwd.launches.values()) == \
        fused_leff.BWD_LAUNCHES * 18
    assert sum(window_attention.launches.values()) == 10
    bwd = wa.window_attn_bwd.launches
    assert sum(bwd.values()) == 10 * 3
    assert sum(n for k, n in bwd.items() if k[4]) == 3 * 3
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert torch.count_nonzero(p.grad) > 0, name


@pytest.mark.cuda
def test_window_attn_refuses_unsupported_shape(cuda):
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, torch.float32, 1, 2, 9, 8, False, True, 17)
    with pytest.raises(ValueError, match="N <= 64"):
        window_attention(q, k, v, bias, scale=scale, sparse_w=w)


WIDE = [(4, 4, 8, 128, False, True), (4, 2, 8, 96, True, False),
        (4, 2, 4, 128, True, True)]
WIDE_IDS = ["N64-d128-sparse", "N64-d96-masked-dense", "N16-d128-masked"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw, heads, ws, d, masked, sparse", WIDE,
                         ids=WIDE_IDS)
def test_window_attn_wide_heads_match_plain(cuda, dtype, nw, heads, ws, d,
                                            masked, sparse):
    """Heads of up to 128 channels (NewModel's decoder 3 and bottleneck):
    the forward within AST_TOL of max|out|, every gradient of the kernel
    backward within BWD_TOL of its max|ref| (the f32 backward at d > 64
    runs in phases over two operand slots), two bf16 backward calls
    bit-equal."""
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, dtype, nw, heads, ws, d, masked, sparse, 20)
    kw = dict(scale=scale, sparse_w=w, mask=mask)
    got = window_attention(q, k, v, bias, **kw)
    want = window_attention_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= AST_TOL[dtype] * want.float().abs().max().item()
    g = torch.randn_like(q)
    one = wa.window_attn_bwd(g, q, k, v, bias, **kw)
    ref = wa.window_attention_bwd(g, q, k, v, bias, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(one, ref)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), (i, err)
    if dtype == torch.bfloat16:
        two = wa.window_attn_bwd(g, q, k, v, bias, **kw)
        assert all(a is None or torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_window_attn_refuses_wider_heads(cuda):
    q, k, v, bias, w, mask, scale = _attn_inputs(
        cuda, torch.bfloat16, 1, 2, 8, 129, False, True, 21)
    with pytest.raises(ValueError, match="d <= 128"):
        window_attention(q, k, v, bias, scale=scale, sparse_w=w)
    with pytest.raises(ValueError, match="d <= 128"):
        wa.window_attn_bwd(q, q, k, v, bias, scale=scale, sparse_w=w)


@pytest.mark.cuda
@pytest.mark.parametrize("use_dwt", ["Wavelet", "Fourier"])
def test_new_model_goes_through_the_kernels(cuda, use_dwt):
    """A small NewModel on the card (img_size 64, embed 16, heads up to 64
    channels): 9 LN+LeFF calls and 10 window attentions through the
    kernels, the output close to the plain versions' in f32."""
    model = init_model("NewModel", device=cuda, seed=5, img_size=64,
                       embed_dim=16, use_dwt=use_dwt)
    fused_leff.ln_leff.launches.clear()
    window_attention.launches.clear()
    x = torch.rand(2, 3, 64, 64, device=cuda) * 2 - 1
    with torch.no_grad():
        got = model(x)
        want = model(x, use_kernels=False)
    torch.cuda.synchronize()
    assert len(fused_leff.ln_leff.launches) == 9
    assert sum(window_attention.launches.values()) == 10
    assert max(k[3] for k in window_attention.launches) == 64
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_new_model_gradients_reach_every_parameter(cuda):
    """A NewModel-Wavelet train-mode backward on the card, heads of 16 to
    128 channels (embed 32 at 64x64; DropPath at rate 0): every
    parameter's gradient finite and non-zero, 9 LN+LeFF backwards and 10
    window attention backwards (three launches each) through the kernels,
    and two bf16 passes bit-equal."""
    model = init_model("NewModel", device=cuda, seed=6, img_size=64,
                       embed_dim=32, use_dwt="Wavelet",
                       drop_path_rate=0.0).train()
    x = torch.rand(2, 3, 64, 64, device=cuda) * 2 - 1

    def grads():
        model.zero_grad(set_to_none=True)
        model(x).float().square().mean().backward()
        torch.cuda.synchronize()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    fused_leff.ln_leff_bwd.launches.clear()
    wa.window_attn_bwd.launches.clear()
    got = grads()
    assert len(fused_leff.ln_leff_bwd.launches) == 9
    assert sum(wa.window_attn_bwd.launches.values()) == 10 * 3
    assert max(k[3] for k in wa.window_attn_bwd.launches) == 128
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert torch.count_nonzero(g) > 0, name
    model.compute_dtype = torch.bfloat16
    torch.backends.cudnn.deterministic = True
    try:
        one, two = grads(), grads()
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(torch.equal(one[n], two[n]) for n in one)


@pytest.mark.cuda
def test_trainer_resume_is_bit_exact_on_the_card(cuda, tmp_path, monkeypatch):
    """Two epochs of ``ModelTrainer.train`` on the card through the kernels
    (a small SpectralTransformer, 32x32, batch 2 with a padded final batch,
    bf16, Adam, watch every 2nd step) equal one epoch and a resumed one bit
    for bit: parameters, Adam's state, loader state; all four Spectral
    kernels launched.  The test sets no cuDNN flag: the trainer does."""
    _trainer_resume_case(cuda, tmp_path, monkeypatch, steps_per_dispatch=1)


@pytest.mark.cuda
def test_trainer_resume_with_steps_per_dispatch_on_the_card(
        cuda, tmp_path, monkeypatch):
    """The same with ``steps_per_dispatch=2`` (3 batches an epoch: a group
    and a remainder; capturable Adam): the straight run's second epoch
    replays its CUDA graph, captured again for the epoch's learning rate,
    while the resumed run's first call is eager, and both end bit-equal."""
    _trainer_resume_case(cuda, tmp_path, monkeypatch, steps_per_dispatch=2)


def _trainer_resume_case(cuda, tmp_path, monkeypatch, steps_per_dispatch):
    from PIL import Image

    from underwater_image_restoration_torch.core.config import Config
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.train import (
        CheckpointManager,
        trainer,
    )

    dirs = []
    for split, n, seed in (("train", 5, 0), ("test", 3, 1)):
        for sub, arr in zip("ab", synthetic_pair_batch(n, 32, seed=seed)):
            d = tmp_path / split / sub
            d.mkdir(parents=True)
            for i, img in enumerate(arr):
                Image.fromarray(img).save(d / f"{i:03d}.png")
            dirs.append(str(d))
    monkeypatch.setattr(trainer, "init_model", lambda arch, **k: init_model(
        "SpectralTransformer", device=k["device"], seed=k["seed"],
        compute_dtype=k["compute_dtype"], channels=(16, 32, 64, 128),
        num_blocks=(1, 1, 1, 1), num_refinement=1))
    cfg = Config(image_size=32, train_batch_size=2, test_batch_size=2,
                 use_wandb=False, workers=1, watch_freq=2,
                 lossf="L1withColor", print_freq=100,
                 steps_per_dispatch=steps_per_dispatch)
    counters = (fused_mdta.ln_mdta, fused_mdta.ln_mdta_bwd,
                fused_gdfn.ln_gdfn, fused_gdfn.ln_gdfn_bwd)
    for c in counters:
        c.launches.clear()
    runs = {}
    for name, epochs in (("straight", 2), ("resumed", 1)):
        ckpt = tmp_path / name
        trainer.ModelTrainer(*dirs).train(cfg.replace(
            checkpoint_dir=str(ckpt), max_epoch=epochs))
        runs[name] = str(next(ckpt.iterdir()))
    assert all(sum(c.launches.values()) for c in counters)
    trainer.ModelTrainer(*dirs).train(cfg.replace(
        max_epoch=2, resume=runs["resumed"]))
    a, b = (CheckpointManager(os.path.join(runs[n], "latest")).restore()
            for n in ("straight", "resumed"))
    assert a["epoch"] == b["epoch"] == 1 and a["loader"] == b["loader"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    sa, sb = a["opt_state"]["inner"]["state"], b["opt_state"]["inner"]["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# the losses whose value and gradient need sides > 160 (MS-SSIM), and the
# perceptual family, whose gradient is discontinuous (the sign of each L1
# term, the VGG ReLUs): f32 roundoff on either device flips some of those
# points, so it is held in relative L2 norm
_LARGE_LOSSES = ("ms_ssim", "mix", "fflMixTV", "bigMix", "fflMix",
                 "ssimFFLCharbonnier", "perceptual")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "L1", "L1withColor", "L1ColorLum", "L2", "charbonnier", "perceptual",
    "gradient", "ms_ssim", "ffl", "mix", "fflMixTV", "bigMix",
    "fflCharbonnier", "fflMix", "LuminanceCharbonnier", "Luminance",
    "AdaptiveLuminanceCharbonnier", "AdaptiveLuminanceFFL", "LuminanceFFL",
    "ssimFFLCharbonnier"])
def test_loss_on_the_card_matches_the_cpu(cuda, name):
    """Each loss name's value and gradient on the card against the same
    function on the CPU, f32 (TF32 off): the value within 1e-4 relative,
    the gradient within 1e-4 x max|ref| (the perceptual family's in relative
    L2, 1e-2; the placeholder VGG trunk on both)."""
    from underwater_image_restoration_torch.losses import (
        PERCEPTUAL_FAMILY,
        LossFunction,
    )

    shape = (1, 3, 176, 176) if name in _LARGE_LOSSES else (2, 3, 16, 12)
    g = torch.Generator().manual_seed(8)
    p, t = (torch.rand(shape, generator=g) * 2 - 1 for _ in range(2))
    fn = LossFunction(name, allow_placeholder_vgg=True)

    def value_and_grad(dev):
        x = p.to(dev).detach().requires_grad_()
        res = fn(x, t.to(dev))
        loss = res[0] if fn.returns_components else res
        loss.backward()
        return float(loss), x.grad.cpu()

    want, want_g = value_and_grad("cpu")
    got, got_g = value_and_grad(cuda)
    assert abs(got - want) <= 1e-4 * abs(want)
    if name in PERCEPTUAL_FAMILY:
        assert (got_g - want_g).norm() <= 1e-2 * want_g.norm()
    else:
        assert (got_g - want_g).abs().max() <= 1e-4 * want_g.abs().max()


@pytest.mark.cuda
def test_eval_pairs_through_the_kernels(cuda, tmp_path):
    """``evaluate_pairs`` on a NewModel-Wavelet at 256x256 (5 pairs, batch
    2, f32) through ln_leff and window_attn equals its run through the plain
    versions: every PSNR within 1e-3 dB, the dumped references equal."""
    from PIL import Image

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval import evaluate

    raw, ref = synthetic_pair_batch(5, 256, seed=9)
    dirs = []
    for sub, arr in zip("ab", (raw, ref)):
        d = tmp_path / sub
        d.mkdir()
        for i, img in enumerate(arr):
            Image.fromarray(img).save(d / f"{i}.png")
        dirs.append(str(d))
    model = init_model("NewModel", device=cuda, seed=10, img_size=256,
                       use_dwt="Wavelet", compute_dtype=torch.float32)
    fused_leff.ln_leff.launches.clear()
    window_attention.launches.clear()
    out = {}
    for use in (True, False):
        out[use] = evaluate.evaluate_pairs(
            model, *dirs, str(tmp_path / f"pred{use}"),
            str(tmp_path / f"ref{use}"), image_size=256, batch_size=2,
            use_kernels=use)
    assert sum(fused_leff.ln_leff.launches.values()) > 0
    assert sum(window_attention.launches.values()) == 3 * 10
    assert out[True].shape == (5,) and np.isfinite(out[True]).all()
    np.testing.assert_allclose(out[True], out[False], atol=1e-3)
    for i in range(5):
        a, b = (np.asarray(Image.open(tmp_path / f"ref{u}" / f"{i}.png"))
                for u in (True, False))
        assert np.array_equal(a, b)


def _op_cases(cuda, dtype):
    """(name, op arguments, the direct kernel call) of each custom op."""
    rng = np.random.default_rng(61)
    x, wm = _fwd_case("mdta", (2, 32, 20, 36), 2, dtype, cuda, seed=61)
    _, wg = _fwd_case("gdfn", (2, 32, 20, 36), 1, dtype, cuda, seed=62)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(cuda)

    tok = t(2, 12, 20, 32).to(dtype)
    wl = (1 + 0.1 * t(32), 0.1 * t(32), t(32, 48, scale=32 ** -0.5),
          0.1 * t(48), t(3, 3, 48, scale=1 / 3), 0.1 * t(48),
          t(48, 32, scale=48 ** -0.5), 0.1 * t(32))
    s = torch.tensor([1.25, 0.0], device=cuda)
    q, k, v = (t(8, 2, 64, 32).to(dtype) for _ in range(3))
    bias, w, mask = t(2, 64, 64), t(2), t(4, 64, 64)

    def leff_direct():
        ops = fused_leff.kernel_operands(*wl[2:], dtype)
        return (fused_leff._forward_cuda(tok, wl[0], wl[1], ops, s, 1e-5,
                                         True),)

    return [
        ("ln_mdta", (x, *wm, 2, 1e-5),
         lambda: fused_mdta.forward_with_stats(x, *wm, 2)),
        ("ln_gdfn", (x, *wg, 1e-5),
         lambda: fused_gdfn._launch(x, *wg, 1e-5)),
        ("ln_leff", (tok, *wl, s, 1e-5, True), leff_direct),
        ("window_attn", (q, k, v, bias, w, mask, 0.2),
         lambda: (wa._forward_cuda(q, k, v, bias, 0.2, w, mask),)),
    ]


OP_COUNTERS = {"ln_mdta": fused_mdta.ln_mdta.launches,
               "ln_gdfn": fused_gdfn.ln_gdfn.launches,
               "ln_leff": fused_leff.ln_leff.launches,
               "window_attn": wa.window_attention.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", range(4),
                         ids=["ln_mdta", "ln_gdfn", "ln_leff", "window_attn"])
def test_custom_op_is_the_kernel(cuda, dtype, index):
    """The op's outputs are the direct kernel call's, bit for bit (the
    leading one: y; then what the backward reads), and it launches as
    many kernels."""
    name, args, direct = _op_cases(cuda, dtype)[index]
    op = getattr(torch.ops.uir, name)
    counter = OP_COUNTERS[name]
    counter.clear()
    want = direct()
    n_direct = sum(counter.values())
    counter.clear()
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert sum(counter.values()) == n_direct > 0
    assert len(got) >= len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", range(4),
                         ids=["ln_mdta", "ln_gdfn", "ln_leff", "window_attn"])
def test_custom_op_passes_opcheck(cuda, dtype, index):
    name, args, _ = _op_cases(cuda, dtype)[index]
    op = getattr(torch.ops.uir, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.cuda
def test_exported_program_runs_the_kernels(cuda, tmp_path):
    """A small SpectralTransformer exported on the card (symbolic batch):
    one ln_mdta and one ln_gdfn node a block, the reloaded program equal
    to the eager forward at batch 2 and 3, launching the kernels."""
    from underwater_image_restoration_torch.tools import export_model as em

    model = init_model("SpectralTransformer", seed=3,
                       compute_dtype=torch.bfloat16,
                       channels=(16, 32, 64, 128), num_blocks=(1, 1, 1, 1),
                       num_refinement=1)
    program = em.export_module(model, 32)
    assert dict(em.custom_op_counts(program)) == {"ln_mdta": 8,
                                                  "ln_gdfn": 8}
    torch.export.save(program, str(tmp_path / "m.pt2"))
    fn = em.load_exported(str(tmp_path / "m.pt2"))
    for b in (2, 3):
        x = torch.rand(b, 32, 32, 3, device=cuda) * 2 - 1
        with torch.no_grad():
            want = em.ServingForward(model)(x)
        for c in OP_COUNTERS.values():
            c.clear()
        got = fn(x)
        torch.cuda.synchronize()
        assert sum(OP_COUNTERS["ln_mdta"].values()) > 0
        assert sum(OP_COUNTERS["ln_gdfn"].values()) > 0
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_model_takes_a_strided_input(cuda):
    """An NHWC batch permuted to NCHW (not contiguous) goes through the
    SpectralTransformer's kernels (the model makes its input contiguous;
    cuDNN would give a channels-last activation otherwise) and gives the
    contiguous input's output."""
    model = init_model("SpectralTransformer", seed=4,
                       channels=(16, 32, 64, 128), num_blocks=(1, 1, 1, 1),
                       num_refinement=1)
    nhwc = torch.rand(2, 32, 32, 3, device=cuda) * 2 - 1
    with torch.no_grad():
        got = model(nhwc.permute(0, 3, 1, 2))
        want = model(nhwc.permute(0, 3, 1, 2).contiguous())
    assert torch.equal(got, want)


# the kernels' launch tallies of a train step
_TALLIES = (fused_mdta.ln_mdta, fused_mdta.ln_mdta_bwd, fused_gdfn.ln_gdfn,
            fused_gdfn.ln_gdfn_bwd, fused_leff.ln_leff, fused_leff.ln_leff_bwd,
            window_attention, wa.window_attn_bwd)


def _tallies():
    return [dict(f.launches) for f in _TALLIES]


def _moved(before, after):
    return [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
            for b, a in zip(before, after)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["SpectralTransformer", "AST", "AST-remat"])
def test_graph_replays_equal_eager_steps(cuda, arch, monkeypatch):
    """Three calls of ``make_train_step(k_steps=2)`` (two eager steps, then
    one CUDA graph of the step captured and replayed four times) against
    six eager single steps from the same weights, capturable Adam and
    DropPath seed (the AST at its rate 0.1; with per-block remat too), bf16
    at 32x32: losses, grad norms, parameters, Adam's state and the
    generator's state bit-equal; the kernels' tallies move during the
    capture by one step's launches and not during the replays."""
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    if arch == "SpectralTransformer":
        kw = dict(seed=2, channels=(16, 32, 64, 128),
                  num_blocks=(1, 1, 1, 1), num_refinement=1)
    else:
        kw = dict(seed=3, img_size=32, embed_dim=8, win_size=4,
                  remat=arch == "AST-remat")
    batches = [synthetic_pair_batch(2, 32, seed=40 + i) for i in range(6)]

    def run(k):
        model = init_model(arch.split("-")[0], device=cuda,
                           compute_dtype=torch.bfloat16, **kw)
        opt = get_optimizer("adam", model.parameters(), 3e-4,
                            capturable=True)
        gen = torch.Generator(cuda).manual_seed(7)
        step = make_train_step(model, LossFunction("L1withColor"), opt,
                               generator=gen, k_steps=k)
        ms, moved = [], []
        for i in range(0, 6, k):
            group = batches[i:i + k]
            before = _tallies()
            if k == 1:
                ms.append(step(*group[0]))
            else:
                ms.append(step(np.stack([r for r, _ in group]),
                               np.stack([f for _, f in group])))
            torch.cuda.synchronize()
            moved.append(_moved(before, _tallies()))
        out = {key: torch.cat([m[key].reshape(-1) for m in ms])
               for key in ms[0]}
        return (out, {n: p.detach().clone()
                      for n, p in model.named_parameters()},
                opt.state_dict()["inner"]["state"], gen.get_state(), moved,
                step)

    eager = run(1)
    graph = run(2)
    for key in eager[0]:
        assert graph[0][key].shape == (6,), key
        assert torch.isfinite(eager[0][key]).all(), key
        assert torch.equal(eager[0][key], graph[0][key]), key
    for n in eager[1]:
        assert torch.equal(eager[1][n], graph[1][n]), n
    for i, st in eager[2].items():
        for key, v in st.items():
            assert torch.equal(v, graph[2][i][key]), (i, key)
    assert torch.equal(eager[3], graph[3])
    one_step = eager[4][0]
    assert any(one_step)
    # call 1 runs two eager steps, call 2 captures one and replays
    assert graph[4][0] == [{k: 2 * n for k, n in t.items()}
                           for t in one_step]
    assert graph[4][1] == one_step
    assert graph[4][2] == [{} for _ in one_step]
    assert graph[5].captures == 1
