"""The check has to fail what is wrong. The control (the reference in fp8,
the precision below the configurations' bfloat16, in the port's place)
comes out not correct under each cell's limits; so does a whole run with a
fault planted under the timed path. On the CPU at a small size, and with
the ``gpu`` marker at the cells' own size on the card:

    python -m pytest benchmark -q -m gpu      # on a machine with a card
"""
import time

import pytest
import torch

import readings
from portbench import check, harness
from portbench.runners.base import FAULTS
from test_portbench_reference import SEED, SIZES, cell, manifest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_at_a_small_size(workload):
    cell_ = cell(workload)
    for seed in (SEED, SEED + 1):
        numbers = readings.seed_readings(cell_, seed, ["control"], torch.device("cpu"),
                                         SIZES[workload])["control"]
        assert not check.verdict(numbers, cell_.limits), numbers


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_run_with_a_fault_is_not_correct(workload, fault):
    result = harness.run(workload, SEED, 0.5, trace=False, t_start=time.perf_counter(),
                         device="cpu", sizes=SIZES[workload], dtype=torch.float32, fault=fault,
                         manifest=manifest())
    assert not result["correct"] and result["failed"] == result["attempted"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_at_the_cells_size(workload, card):
    cell_ = cell(workload)
    for seed in (7001, 7002, 7003):
        numbers = readings.seed_readings(cell_, seed, ["control"], card)["control"]
        assert not check.verdict(numbers, cell_.limits), numbers
