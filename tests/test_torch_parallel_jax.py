"""The port's train step at the global batch against the JAX package's
train step over ``make_mesh(data=2, context=1)`` (the conftest's virtual
CPU devices: XLA's SPMD partitioner splits the batch over the two), on the
CPU in f32, at the JAX package's ``_CP_MODELS`` SpectralTransformer
(``tests/test_parallel.py:158``): the global batch of 4 at 16x16, same
weights (the port's init through ``convert_spectral_transformer``) and
batches, two SGD steps (momentum 0.9), losses and grad norms within 1e-4
relative and every parameter within 1e-4 x max(1, max|ref|), for the
B*C-divided ``L1withColor`` (``AdaptiveLuminanceCharbonnier`` in
``test_torch_parallel_jax_adaptive.py``: a JAX step's compile takes 25-40
s on one core, so each file compiles one).  The port's two-rank
data-parallel step is held to this one-process step at 1e-6 in
``test_torch_parallel.py`` (same cases, weights and batches), so the two
ranks match the JAX data mesh through it.  The JAX steps are compiled with
XLA's backend optimizations off (the same program).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import CASES, _batches, run_steps
from underwater_image_restoration_tpu.core.meshes import make_mesh
from underwater_image_restoration_tpu.losses import LossFunction as JaxLoss
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_tpu.train import (
    TrainState,
    get_optimizer as jax_optimizer,
    make_train_step as jax_train_step,
)
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    params_from_jax,
)

TOL = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_steps(case):
    """The JAX step over the data mesh: ([(loss, grad_norm)], the port's
    parameter names -> tensors)."""
    arch, kw, loss, size = CASES[case]
    port = init_model(arch, device="cpu", seed=3, **kw)
    params = {"params": jax.tree.map(jnp.asarray, unflatten(
        convert_spectral_transformer({k: v.numpy() for k, v in
                                      port.state_dict().items()})))}
    tx = jax_optimizer("sgd", 1e-2, momentum=0.9)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    step = jax_train_step(JaxSpectralTransformer(**kw), JaxLoss(loss), tx,
                          mesh=make_mesh(data=2, context=1))
    compiled, metrics = None, []
    for raw, ref in _batches(size):
        args = (state, raw, ref, jax.random.PRNGKey(0))
        if compiled is None:
            compiled = step.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        state, m = compiled(*args)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, params_from_jax(flatten(jax.tree.map(
        np.asarray, state.params["params"])))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_against_jax(case):
    (gm, gp, _), (wm, wp) = run_steps(case), _jax_steps(case)
    np.testing.assert_allclose(np.array(gm), np.array(wm), rtol=TOL,
                               atol=0)
    assert sorted(gp) == sorted(wp)
    for n, w in wp.items():
        w = w.numpy()
        np.testing.assert_allclose(
            gp[n].numpy(), w, rtol=0,
            atol=TOL * max(1.0, float(np.abs(w).max())), err_msg=n)


def test_one_process_step_matches_jax_data_mesh():
    check_against_jax("l1withcolor")
