"""K = 2 train steps a call on two gloo ranks against JAX's mesh x unroll
on ``make_mesh(2)`` for the mean teacher, MixUp under the ``ft`` step and
DMT ``method1``, host-fed, as tests/test_torch_parallel_unroll_jax.py holds
``semi`` with the consistency hook (its setup, draws and tolerances)."""
import pytest

from test_torch_parallel_unroll_jax import check_config, spawned_runs

NAMES = ["dmt_method1", "mixup", "mt"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawned_runs(tmp_path_factory.mktemp("dp_unroll_jax_hooks"), NAMES, cached=False)


@pytest.mark.parametrize("name", NAMES)
def test_unrolled_ranks_match_jax_mesh_unroll(runs, name):
    check_config(runs, name)
