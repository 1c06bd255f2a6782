"""Dense InfoNCE of the PyTorch port (hooks/infonce.py, Up_conv2 on an 8 x 8
grid, by self) on two gloo ranks held against JAX's sharded step on
``make_mesh(2)`` run op by op (``jax.disable_jit``): JAX's jitted dense
hooks drift from its op-by-op run by more than the port does
(tests/test_torch_semi_dense.py). The setup, the draws (the dense points
replayed from JAX's hook key at the global batch) and the tolerances are
tests/test_torch_parallel_hooks_jax.py's: the losses rel 2e-3, the model's
parameters atol 2e-3 (JAX's own bound for ``nce_dense`` sharded against
unsharded, tests/test_parallel.py).
"""
import pytest

from test_torch_parallel_hooks_jax import (JAX_HOOKS, check_against_jax, initial_weights,
                                           jax_sharded_step, rank_results)

NAMES = ["dense_nce"]


@pytest.fixture(scope="module")
def weights():
    return initial_weights()


@pytest.fixture(scope="module")
def jax_runs(weights):
    _, params, stats = weights
    return {name: jax_sharded_step(name, params, stats) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(weights, jax_runs, tmp_path_factory):
    return rank_results(NAMES, weights[0], jax_runs, tmp_path_factory.mktemp("dp_dense_jax"))


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_jax_op_by_op_sharded_step(ranks, jax_runs, name):
    check_against_jax(ranks[0][name], jax_runs[name], JAX_HOOKS[name][1])
