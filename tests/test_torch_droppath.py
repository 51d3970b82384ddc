"""The port's DropPath (``ops/droppath.py``) and its use in the AST, on the
CPU.  The JAX package's DropPath draws from ``jax.random``, whose stream
torch cannot reproduce, so these check the distribution and the plumbing:

- one seed gives the same draws, and each call draws anew;
- the scales are 0 or 1/keep, kept at a frequency of keep over many draws
  (20000 draws at keep 0.75: the limit 0.015 is five standard deviations);
- the identity in eval mode and at rate 0, where nothing is drawn;
- a training-mode call at a non-zero rate without a generator raises;
- ``forward`` scales the branch by 1/keep where ``sample_scale`` from the
  same seed keeps it, in the branch's dtype, and zeroes it elsewhere;
- an AST forward in training mode draws the same numbers with
  ``use_kernels`` True and False: the same output, and the generator left
  in the same state, that of 25 draws of a batch (7 encoder blocks at a
  non-zero rate, one branch each; 2 + 7 attention blocks, two each).
"""
import pytest
import torch

from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops import DropPath


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_same_seed_same_draws_and_each_call_draws_anew():
    dp = DropPath(0.5).train()
    g1, g2 = _gen(3), _gen(3)
    a, b = dp.sample_scale(64, g1), dp.sample_scale(64, g2)
    assert torch.equal(a, b)
    assert not torch.equal(a, dp.sample_scale(64, g1))


def test_scales_and_keep_frequency():
    rate = 0.25
    s = DropPath(rate).train().sample_scale(20000, _gen(0))
    assert s.dtype == torch.float32 and s.shape == (20000,)
    inv_keep = float(torch.tensor(1.0) / (1 - rate))  # 1/keep in f32
    assert set(s.unique().tolist()) == {0.0, inv_keep}
    assert abs(float((s > 0).float().mean()) - (1 - rate)) < 0.015


def test_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 5)
    g = _gen(1)
    before = g.get_state()
    assert DropPath(0.3).eval()(x, g) is x
    assert DropPath(0.0).train()(x, g) is x
    assert DropPath(0.3).eval().sample_scale(4, g) is None
    assert DropPath(0.0).train().sample_scale(4, None) is None
    assert torch.equal(g.get_state(), before)


def test_training_without_a_generator_raises():
    dp = DropPath(0.1).train()
    with pytest.raises(ValueError, match="generator"):
        dp(torch.ones(2, 3))
    with pytest.raises(ValueError, match="generator"):
        dp.sample_scale(2, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_sample_scale(dtype):
    rate, keep = 0.4, 0.6
    x = torch.randn(32, 4, 6).to(dtype)
    dp = DropPath(rate).train()
    s = dp.sample_scale(32, _gen(5))
    y = dp(x, _gen(5))
    assert y.dtype == dtype and 0 < int((s > 0).sum()) < 32
    kept = s > 0
    assert torch.equal(y[kept], x[kept] / keep)
    assert not y[~kept].any()


def test_ast_routes_draw_alike():
    model = init_model("AST", device="cpu", img_size=32, embed_dim=8,
                       win_size=4).train()
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    outs, states = [], []
    for use_kernels in (True, False):
        g = _gen(7)
        with torch.no_grad():
            outs.append(model(x, use_kernels, generator=g))
        states.append(g.get_state())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(states[0], states[1])
    ref = _gen(7)
    for _ in range(25):
        torch.rand(2, generator=ref)
    assert torch.equal(states[0], ref.get_state())
    with torch.no_grad():  # a different draw moves the output
        other = model(x, generator=_gen(8))
    assert not torch.equal(other, outs[0])
