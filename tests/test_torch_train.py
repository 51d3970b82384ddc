"""The port's train step (``train/trainer.py``) against the JAX package's
``make_train_step`` on the CPU, in f32, at a small SpectralTransformer
(channels 8/16/32/64, one block a stage, one refinement block), batch 2 at
32x32, ``L1withColor``.  Both start from the same weights (the port's init,
carried to the JAX tree by the JAX package's converter) and the same uint8
batches; the JAX model runs its unfused NHWC path.

- Adam (lr 3e-4, clip 1.0), three steps: loss and grad_norm of each, and
  after the first every parameter's gradient (the JAX chain records its raw
  gradients; the port's ``.grad`` holds them after the clip, so the JAX ones
  are clipped the same way), mapped through ``params_from_jax``;
- SGD (momentum 0.9, clip 1.0), three steps: every parameter after them
  (SGD is linear in the gradient; Adam's first steps are lr * sign(g),
  where roundoff flips a few elements);
- ``grad_accum=2`` against ``grad_accum=1`` in the port, the refusal of the
  Adaptive loss, and zero (not None) gradients for the dead parameters;
- the AST (32x32, window 4, the default drop-path rate 0.1) through
  ``make_train_step`` with a DropPath generator: finite loss and grad_norm,
  the same steps from the same seed, other draws from another, and
  ``grad_accum=2`` drawing per microbatch (the JAX rng stream cannot be
  reproduced; the AST's gradients are held against JAX at rate 0 in
  ``tests/test_torch_ast.py``).

Tolerances: 1e-4 x max(1, max|ref|) as the forward test (FFT roundoff
between torch.fft and jnp.fft), relative to the largest gradient for
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from underwater_image_restoration_tpu.losses import (
    LossFunction as JaxLossFunction,
)
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_tpu.train import optim as jax_optim
from underwater_image_restoration_tpu.train import trainer as jax_trainer
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    params_from_jax,
)
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
    normalize_u8,
)

CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    port = init_model("SpectralTransformer", device="cpu", seed=3, **CFG)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    batches = [synthetic_pair_batch(2, 32, seed=s) for s in range(3)]
    return flat, batches


def _port_model(flat):
    model = init_model("SpectralTransformer", device="cpu", seed=0, **CFG)
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model


def _jax_step(flat, tx):
    params = {"params": jax.tree.map(jnp.asarray, unflatten(flat))}
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros((), jnp.int32))
    step = jax_trainer.make_train_step(JaxSpectralTransformer(**CFG),
                                       JaxLossFunction("L1withColor"), tx)
    return state, step


def _record_grads():
    """An optax stage that keeps the last raw gradients in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, scale))


def test_normalize_matches_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    np.testing.assert_array_equal(
        normalize_u8(torch.from_numpy(u8)).numpy(),
        np.asarray(jax_trainer.normalize_u8(u8)))


def test_adam_steps_and_gradients_match_jax(setup):
    flat, batches = setup
    tx = optax.chain(_record_grads(), jax_optim.get_optimizer("adam", 3e-4))
    state, jstep = _jax_step(flat, tx)
    model = _port_model(flat)
    step = make_train_step(model, LossFunction("L1withColor"),
                           get_optimizer("adam", model.parameters(), 3e-4))
    rng = jax.random.PRNGKey(0)
    for i, (raw, ref) in enumerate(batches):
        state, want = jstep(state, raw, ref, rng)
        got = step(raw, ref)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=TOL)
        if i:
            continue
        gnorm = float(want["grad_norm"])
        clip = 1.0 / gnorm if gnorm >= 1.0 else 1.0
        grads = params_from_jax(flatten(state.opt_state[0]["params"]))
        top = max(float(g.abs().max()) for g in grads.values())
        named = dict(model.named_parameters())
        assert sorted(named) == sorted(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(
                named[name].grad.numpy(), g.numpy() * clip,
                atol=TOL * top * clip, err_msg=name)


def test_sgd_trajectory_matches_jax(setup):
    flat, batches = setup
    tx = jax_optim.get_optimizer("sgd", 1e-2)
    state, jstep = _jax_step(flat, tx)
    model = _port_model(flat)
    step = make_train_step(model, LossFunction("L1withColor"),
                           get_optimizer("sgd", model.parameters(), 1e-2))
    rng = jax.random.PRNGKey(0)
    for raw, ref in batches:
        state, want = jstep(state, raw, ref, rng)
        got = step(raw, ref)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=TOL)
    want = params_from_jax(flatten(jax.tree.map(np.asarray,
                                                state.params["params"])))
    for name, p in model.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(),
               float(want[name].abs().max()))


def _grads(model, grad_accum, loss="L1withColor"):
    opt = get_optimizer("sgd", model.parameters(), 0.0, momentum=0.0,
                        clip_norm=0.0)
    step = make_train_step(model, LossFunction(loss), opt,
                           grad_accum=grad_accum)
    raw, ref = synthetic_pair_batch(2, 32, seed=5)
    out = step(raw, ref)
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_grad_accum_matches_full_batch(setup):
    flat, _ = setup
    for loss in ("L1withColor", "charbonnier"):
        one, g1 = _grads(_port_model(flat), 1, loss)
        two, g2 = _grads(_port_model(flat), 2, loss)
        np.testing.assert_allclose(float(two["loss"]), float(one["loss"]),
                                   rtol=1e-5)
        top = max(float(g.abs().max()) for g in g1.values())
        for name in g1:
            np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(),
                                       atol=1e-5 * top, err_msg=name)


def test_adaptive_loss_refuses_grad_accum(setup):
    model = _port_model(setup[0])
    opt = get_optimizer("adam", model.parameters(), 1e-3)
    with pytest.raises(ValueError, match="couple the"):
        make_train_step(model, LossFunction("AdaptiveLuminanceCharbonnier"),
                        opt, grad_accum=2)


def test_dead_parameters_get_zero_gradients(setup):
    _, grads = _grads(_port_model(setup[0]), 1)
    dead = [n for n in grads if "q1X1_1" in n]
    assert len(dead) == 8
    for name, g in grads.items():
        if "q1X1_1" in name:
            assert not g.any(), name
        elif ".kv." in name or ".kv_conv." in name:
            c = g.shape[0] // 2
            assert not g[:c].any() and g[c:].any(), name


def _ast_steps(seed, grad_accum=1):
    model = init_model("AST", device="cpu", seed=1, img_size=32, embed_dim=8,
                       win_size=4)
    step = make_train_step(model, LossFunction("L1withColor"),
                           get_optimizer("adam", model.parameters(), 3e-4),
                           grad_accum=grad_accum,
                           generator=torch.Generator().manual_seed(seed))
    outs = [step(*synthetic_pair_batch(2, 32, seed=i)) for i in range(2)]
    return [(float(o["loss"]), float(o["grad_norm"])) for o in outs], model


def test_ast_step_with_droppath_is_seeded():
    same, model = _ast_steps(0)
    again, model2 = _ast_steps(0)
    other, _ = _ast_steps(1)
    accum, _ = _ast_steps(0, grad_accum=2)
    assert not model.training  # the step restores the mode
    for loss, gnorm in same + accum:
        assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
    assert same == again
    for (n, p), q in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, q), n
    assert same != other and same != accum
