"""The port's optimizers (``train/optim.py``) against the JAX package's optax
chains on the same parameters and gradients: three updates of adam, adamw,
sgd (momentum, nesterov, none) and rmsprop behind clip_by_global_norm(1.0),
with gradients whose global norm is below the clip (0.5) and above it (5),
and the learning rate cut by ``set_learning_rate`` after the first update.
Parameters agree to 1e-6 x max(1, max|p|) (f32 in another order; Adam's
first steps are lr * sign(g) wherever |g| >> eps).  Also ``multistep_lr``,
and the state_dict round trip of ``ClippedOptimizer``: after a few updates
its state, saved and loaded into a new optimizer (through ``torch.save``,
as the checkpoints do), gives a next update bit-equal to the unbroken
run's.
"""
import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from underwater_image_restoration_tpu.train import optim as jax_optim
from underwater_image_restoration_torch.train import optim

SHAPES = ((4, 3), (5,), (2, 3, 2))
CONFIGS = {
    "adam": ("adam", {}),
    "adamw": ("adamw", {"weight_decay": 0.05}),
    "sgd": ("sgd", {}),
    "sgd-nesterov": ("sgd", {"sgd_nesterov": True}),
    "sgd-plain": ("sgd", {"momentum": 0.0}),
    "rmsprop": ("rmsprop", {}),
}


def _problem(norm, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = []
    for _ in range(3):
        g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        total = np.sqrt(sum(float(np.square(a).sum()) for a in g))
        grads.append([a * np.float32(norm / total) for a in g])
    return params, grads


@pytest.mark.parametrize("norm", [0.5, 5.0], ids=["below-clip",
                                                  "above-clip"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_updates_match_optax(config, norm):
    name, kw = CONFIGS[config]
    params, grads = _problem(norm)
    lr = 1e-2
    tx = jax_optim.get_optimizer(name, lr, **kw)
    jp = [jnp.asarray(a) for a in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = optim.get_optimizer(name, tp, lr, **kw)
    for i, g in enumerate(grads):
        if i == 1:
            state = jax_optim.set_learning_rate(state, lr / 4)
            optim.set_learning_rate(opt, lr / 4)
            assert optim.get_learning_rate(opt) == pytest.approx(
                jax_optim.get_learning_rate(state))
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        for p, want in zip(tp, jp):
            want = np.asarray(want)
            np.testing.assert_allclose(
                p.detach().numpy(), want,
                atol=1e-6 * max(1.0, float(np.abs(want).max())),
                err_msg=f"{config} step {i}")


def test_clip_matches_optax_formula():
    """g / ||g|| * max_norm at and above the limit, unchanged below."""
    for norm in (0.5, 1.0, 5.0):
        _, grads = _problem(norm, seed=3)
        g = [torch.from_numpy(a.copy()) for a in grads[0]]
        got = optim.clip_by_global_norm_(g, 1.0)
        upd, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(a) for a in grads[0]], optax.EmptyState())
        assert float(got) == pytest.approx(norm, rel=1e-5)
        for a, b in zip(g, upd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_multistep_lr_matches_jax():
    want = jax_optim.multistep_lr(3e-4)
    got = optim.multistep_lr(3e-4)
    for epoch in range(0, 300, 7):
        assert got(epoch) == want(epoch)
    assert got(0) == 3e-4 and got(1) == 3e-4 * 0.25


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        optim.get_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))], 1.0)


@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_state_dict_round_trip_is_bit_exact(name):
    params, grads = _problem(5.0, seed=3)
    grads = grads + _problem(0.5, seed=4)[1]

    def make(lr):
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
        return ps, optim.get_optimizer(name, ps, lr, clip_norm=2.0)

    def update(ps, opt, g):
        for p, gi in zip(ps, g):
            p.grad = torch.from_numpy(gi.copy())
        return opt.step()

    ps, opt = make(1e-2)
    for g in grads[:4]:
        update(ps, opt, g)
    optim.set_learning_rate(opt, 5e-3)
    buf = io.BytesIO()
    torch.save({"opt": opt.state_dict(),
                "params": [p.detach().clone() for p in ps]}, buf)
    update(ps, opt, grads[4])
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    ps2, opt2 = make(1.0)
    opt2.clip_norm = 0.0
    with torch.no_grad():
        for p, q in zip(ps2, saved["params"]):
            p.copy_(q)
    opt2.load_state_dict(saved["opt"])
    assert opt2.clip_norm == 2.0 and optim.get_learning_rate(opt2) == 5e-3
    update(ps2, opt2, grads[4])
    for p, q in zip(ps, ps2):
        assert torch.equal(p, q)
    for a, b in zip(opt.inner.state.values(), opt2.inner.state.values()):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
