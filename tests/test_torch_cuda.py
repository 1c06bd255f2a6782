"""The port's CUDA kernels (contrastyou_tpu_torch/ops/csrc/tapconv.cu) against
their plain PyTorch versions, on a card. Needs no JAX, so it runs on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card the test skips. Tolerance: both sides accumulate in f32 in
different orders and round once to bf16, so they may differ by one bf16 ulp
(<= 2^-7 of a value) where a rounding flips; allowed: 2^-6 of the largest
value. Shapes are small and deliberately ragged (not multiples of the 8x16
output tile) to exercise the edge masking.
"""
import pytest
import torch

from contrastyou_tpu_torch.ops import convblock as cb
from torch_parity import scaled_close

TOL = 2.0 ** -6


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    x, skip = r(2, 20, 36, 32), r(2, 20, 36, 32)
    w, ws = r(3, 3, 32, 64) * 0.05, r(3, 3, 32, 64) * 0.05
    for got, ref in zip(cb.conv3x3_stats(x, w, skip, ws),
                        cb.conv3x3_stats_plain(x, w, skip, ws)):
        scaled_close(got, ref, tol=TOL)
    x1 = r(3, 13, 21, 1)
    w1 = r(3, 3, 1, 32) * 0.3
    for got, ref in zip(cb.conv3x3_stats(x1, w1), cb.conv3x3_stats_plain(x1, w1)):
        scaled_close(got, ref, tol=TOL)
    taps = cb.parity_taps(r(3, 3, 64, 32) * 0.05)
    xu = r(2, 10, 18, 64)
    for got, ref in zip(cb.upconv3x3_stats(xu, taps), cb.upconv3x3_stats_plain(xu, taps)):
        scaled_close(got, ref, tol=TOL)
    gu = r(2, 20, 36, 32)
    scaled_close(cb.upconv3x3_dx(gu, taps), cb.upconv3x3_dx_plain(gu, taps), tol=TOL)
    torch.cuda.synchronize()


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """On the CPU the wrappers never reach a kernel; the checks that guard
    the kernel launch raise on the device, dtype and channel count."""
    with pytest.raises(ValueError):
        cb._cuda_check("k", torch.zeros(2, dtype=torch.bfloat16))
    assert cb.conv3x3_stats(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 5))[0].shape \
        == (1, 4, 4, 5)
