"""``test_torch_parallel_jax.py``'s check for the Adaptive loss
(``AdaptiveLuminanceCharbonnier``): the port's train step at the global
batch against the JAX package's step over ``make_mesh(data=2, context=1)``,
whose softmax weights come from the global batch's detached losses, as the
port's data-parallel step forms them (``LossFunction.with_batch_mean``;
the two ranks are held to this one-process step in
``test_torch_parallel.py``).  One JAX compile a file keeps each under a
minute on one core.
"""
import pytest
import torch

from test_torch_parallel_jax import check_against_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_process_step_matches_jax_data_mesh():
    check_against_jax("adaptive")
