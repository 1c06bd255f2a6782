"""CPU tests of the operation and byte counts at the cells' shapes against
numbers worked out by hand, and of reading a trace."""
import pytest

from portbench import work
from portbench.trace import Trace, hand_kernel

#: one 224x224 image's forward MACs at max_channel 512, level by level:
#: H*W*9*Cin*Cout of each conv (an upconv at its output resolution)
HAND_MACS = [
    224 * 224 * 9 * 1 * 32, 224 * 224 * 9 * 32 * 32,          # Conv1
    112 * 112 * 9 * 32 * 64, 112 * 112 * 9 * 64 * 64,         # Conv2
    56 * 56 * 9 * 64 * 128, 56 * 56 * 9 * 128 * 128,         # Conv3
    28 * 28 * 9 * 128 * 256, 28 * 28 * 9 * 256 * 256,        # Conv4
    14 * 14 * 9 * 256 * 512, 14 * 14 * 9 * 512 * 512,        # Conv5
    28 * 28 * 9 * 512 * 256, 28 * 28 * 9 * 512 * 256, 28 * 28 * 9 * 256 * 256,   # Up5, Up_conv5
    56 * 56 * 9 * 256 * 128, 56 * 56 * 9 * 256 * 128, 56 * 56 * 9 * 128 * 128,   # Up4, Up_conv4
    112 * 112 * 9 * 128 * 64, 112 * 112 * 9 * 128 * 64, 112 * 112 * 9 * 64 * 64,  # Up3, Up_conv3
    224 * 224 * 9 * 64 * 32, 224 * 224 * 9 * 64 * 32, 224 * 224 * 9 * 32 * 32,    # Up2, Up_conv2
    224 * 224 * 32 * 4,                                        # Deconv_1x1
]


def test_forward_macs_by_hand():
    convs = work.unet_convs(512, 4, 224)
    assert [c.macs() for c in convs] == HAND_MACS
    assert sum(HAND_MACS) == 12_506_267_648      # 25.01 GFLOP an image forward


def test_semi_update_flops():
    """5 labeled + 10 unlabeled images forward and backward; every conv's
    input gradient but the image's."""
    convs = work.unet_convs(512, 4, 224)
    fwd = 2 * sum(HAND_MACS)
    first = 2 * HAND_MACS[0]
    per_image = 3 * fwd - first
    assert work.conv_flops(convs, 5) + work.conv_flops(convs, 10) == 15 * per_image
    assert 15 * per_image == pytest.approx(1.12513e12, rel=1e-5)


def test_pretrain_cut_at_up_conv2():
    convs = work.unet_convs(512, 2, 224, until="Up_conv2")
    assert convs[-1].layer == "Up_conv2.conv1"
    assert [c.macs() for c in convs] == HAND_MACS[:-1]


def test_kernel_sites_of_a_semi_update():
    """The port's graph of 8 updates launches K1 128, K2 16, K3 16, C1 32 and
    C2 144 times (the port's counters): per update a pass of 5 and one of 10."""
    convs = work.unet_convs(512, 4, 224)
    sites = work.kernel_sites(convs, 5) + work.kernel_sites(convs, 10)
    assert work.launches(sites) == {"K1": 16, "K2": 2, "K3": 2, "C1": 4, "C2": 18}


def test_least_time_of_one_launch_by_hand():
    """K1 of Conv1's second conv at batch 5: 2*5*224*224*9*32*32 FLOPs;
    bf16 input, weights and output, f32 statistics; bytes-bound."""
    k1 = [s for s in work.kernel_sites(work.unet_convs(512, 4, 224), 5)
          if s.kernel == "K1" and s.layer == "Conv1.conv1"][0]
    hw = 5 * 224 * 224
    assert k1.flops == 2 * hw * 9 * 32 * 32
    assert k1.bytes == hw * 32 * 2 + 9 * 32 * 32 * 2 + hw * 32 * 2 + 5 * 2 * 32 * 4
    assert k1.least_s() == pytest.approx(k1.bytes / 3.35e12)
    c2 = [s for s in work.kernel_sites(work.unet_convs(512, 4, 224), 10)
          if s.kernel == "C2" and s.layer == "Up_conv3.conv0.skip"][0]
    hw = 10 * 112 * 112
    assert c2.flops == 4 * hw * 9 * 64 * 64
    assert c2.bytes == 2 * hw * 64 * 2 + 9 * 64 * 64 * (2 + 4) + hw * 64 * 2


def test_up2_runs_at_input_resolution():
    sites = [s for s in work.kernel_sites(work.unet_convs(512, 4, 224), 5) if s.layer == "Up2"]
    assert sorted(s.kernel for s in sites) == ["C1", "K2", "K3"]
    assert all(s.flops == 2 * 5 * 112 * 112 * 16 * 64 * 32 for s in sites)


def test_launch_counters_by_family():
    assert work.counted_launches({"conv3x3_stats": 16, "supcon_loss": 2, "conv3x3_bwd_fused": 0}) \
        == {"K1": 16}


def test_kernel_names():
    assert hand_kernel("void tapmma_kernel<32, 64, 1, 2, 4>(MmaParams)") == "K2 upconv3x3_stats"
    assert hand_kernel("void tapmma_kernel<64, 64, 2, 2, 4>(MmaParams)") == "K3 upconv3x3_dx"
    assert hand_kernel("void tapmma_kernel<32, 32, 0, 1, 4>(MmaParams)") == "K1 conv3x3_stats"
    assert hand_kernel("void convbwd_kernel<32, 32>(Params)") == "C2 conv3x3_bwd_fused"
    assert hand_kernel("void at::native::reduce_kernel<128, 4>") is None


def test_trace_union_and_gaps():
    t = Trace(kernels=[(0, 10, "a"), (5, 20, "b"), (30, 40, "c")],
              spans=[(0, 25, "bench/call"), (25, 45, "bench/sync")], window_s=45e-9)
    assert t.busy_s() == pytest.approx(30e-9)
    gaps = dict(t.idle_gaps())     # a gap goes to the span open where it starts
    assert gaps["bench/call (1 gaps)"] == pytest.approx(10e-9)     # 20 .. 30
    assert gaps["bench/sync (1 gaps)"] == pytest.approx(5e-9)      # 40 .. 45
