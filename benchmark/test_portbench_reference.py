"""CPU tests, at a small size: the plain reference agrees with the port run
in float32, and a whole run of each cell (the window, the readers, the
check) comes out correct."""
import json
import time

import pytest
import torch
import torch.nn.functional as F

from portbench import check, harness
from portbench.reference import Precision

#: small sizes of each cell for the CPU (the widths of max_channel 32)
SIZES = {"semi.cached_k8": {"max_channel": 32, "crop": 32, "raw_size": 40, "slices": 8},
         "pretrain_decoder.prostate48": {"max_channel": 32, "crop": 32, "raw_size": 40}}
SEED = 2 ** 31 + 12345


def manifest() -> dict:
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def cell(workload: str):
    return harness.load_cell(workload, manifest())


def program_and_reference(workload, seed, **kwargs):
    cell_ = cell(workload)
    d = harness.make_runner(cell_, seed, "cpu", dtype=torch.float32, sizes=SIZES[workload],
                            **kwargs)
    d.build()
    n = int(cell_.traffic["check_calls"])
    prog = d.first_calls(n)
    d.free()
    ref = harness.make_runner(cell_, seed, "cpu", sizes=SIZES[workload]).reference(
        Precision("float32"), n)
    return cell_, prog, ref


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_reference_agrees_with_the_port_in_float32(workload):
    cell, prog, ref = program_and_reference(workload, SEED)
    updates = int(cell.traffic["check_calls"]) * (8 if workload.startswith("semi") else 1)
    assert len(prog.loss) == len(ref.loss) == updates
    numbers = check.gaps(prog, ref)
    assert numbers["loss"] < 1e-5
    assert numbers["grad"] < 2e-2 and numbers["grad_median"] < 1e-4     # one small leaf at 4.5e-3
    assert numbers["change"] < 1e-2 and numbers["change_median"] < 1e-3   # f32 round-off of tiny updates


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_whole_run_is_correct(workload):
    result = harness.run(workload, SEED, 0.5, trace=False, t_start=time.perf_counter(),
                         device="cpu", sizes=SIZES[workload], dtype=torch.float32,
                         manifest=manifest())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert {"slices_per_s", "setup_s"} <= set(result["metrics"])
    assert set(result["checks"]) == set(cell(workload).limits)


def test_bfloat16_precision_rounds_operands_outputs_and_cotangents():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=g)
    y = Precision("bfloat16").conv(x, w, padding=1)

    def bf(t):
        return t.detach().to(torch.bfloat16).float()

    assert torch.equal(y, bf(F.conv2d(bf(x), bf(w), padding=1)))
    cotangent = torch.randn(y.shape, generator=g)
    y.backward(cotangent)
    want = torch.nn.grad.conv2d_input(x.shape, bf(w), bf(cotangent), padding=1)
    assert torch.allclose(x.grad, want, rtol=1e-6, atol=1e-6)
