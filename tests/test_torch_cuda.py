"""The port's CUDA kernels (contrastyou_tpu_torch/ops/csrc/tapconv.cu,
convbwd.cu, supcon.cu and iic.cu) against their plain PyTorch versions, on a card.
Needs no JAX, so it runs on the machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card the test skips. Tolerance: both sides accumulate in f32 in
different orders and round once to bf16, so they may differ by one bf16 ulp
(<= 2^-7 of a value) where a rounding flips; allowed: 2^-6 of the largest
value. Shapes are small and deliberately ragged (not multiples of the 8x16
output tile) to exercise the edge masking. The SupCon kernels (f32) are held
to loss rtol 1e-5 and dz 1e-4 of its largest value, at anchor counts that are
not multiples of their 16-row tiles or 32-column chunks, with rows that have
no positives, no mask or only negative similarities. The backward kernels' weight gradients
(f32 on both sides) are held to 1e-4 of the largest |dk|, C2's dx (bf16) as
the conv kernels are. The dense-IIC kernels (f32 math on bf16 or f32
features) are held to 1e-5 of the largest raw joint and to DK_TOL of the
largest dW / db (f32 sums over the pixels in another order), their feature
gradients to TOL in bf16 and 1e-5 of the largest value in f32, also on the
dense loss's own cotangent. The CPU
tests here check the wrappers' guards and the cuDNN yardsticks that
chip_smoke.py times.
"""
import pytest
import torch

from contrastyou_tpu_torch.engine.hooks import TrainerHook
from contrastyou_tpu_torch.ops import convblock as cb
from contrastyou_tpu_torch.ops import iic, supcon
from torch_parity import scaled_close

TOL = 2.0 ** -6
#: C1 / C2 weight gradients (f32 on both sides, sums in another order), in
#: units of the largest |dk|
DK_TOL = 1e-4


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


#: (B, H, W, Cin, skip channels, Cout, stats) of K1: ragged H and W that are
#: not multiples of the 16 x 16 (Cout 32) or 8 x 16 (Cout 64) tiles, B = 1 and
#: batches whose tile counts do not divide the persistent grid, Cin 1, skips
#: of 32 and 64, both Couts, and the dx use (no statistics)
K1_CASES = [
    (1, 13, 21, 32, 0, 32, True), (2, 20, 36, 32, 32, 64, True), (3, 1, 40, 64, 64, 64, True),
    (1, 224, 224, 32, 0, 32, True), (7, 57, 45, 64, 0, 32, True), (5, 13, 21, 1, 0, 32, True),
    (2, 224, 224, 1, 0, 64, True), (3, 20, 36, 32, 32, 32, True), (7, 112, 112, 64, 64, 64, True),
    (2, 20, 36, 64, 0, 32, False), (11, 30, 29, 32, 0, 64, False), (1, 3, 5, 1, 0, 64, False),
]
#: (B, H, W, Cout) of K2 (Cin 64): odd tile counts (9 x 16 at Cout 32 is 3
#: tiles of 4 x 16), ragged W, both Couts, B = 1
K2_CASES = [(1, 9, 16, 32), (3, 10, 18, 32), (1, 112, 112, 32), (5, 7, 9, 64), (2, 13, 21, 64)]


def _twice(launch):
    """Two launches of the same kernel on the same inputs: the outputs and
    the stat partials must be the same bits."""
    (o1, p1), (o2, p2) = launch(), launch()
    assert torch.equal(o1, o2)
    assert (p1 is None) == (p2 is None)
    if p1 is not None:
        assert torch.equal(p1, p2)
    return o1, p1


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cin,cs,cout,stats", K1_CASES)
def test_k1_tiles_match_plain_and_repeat_bitwise(B, H, W, cin, cs, cout, stats):
    """K1 against its plain version at tilings that stress the persistent
    grid and the halo copies; outputs and partials bitwise the same over two
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * 1000 + H + W + cin + cout)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(torch.bfloat16)

    scale = (9 * (cin + cs)) ** -0.5
    x, w = r(B, H, W, cin), r(3, 3, cin, cout, scale=scale)
    skip, ws = (r(B, H, W, cs), r(3, 3, cs, cout, scale=scale)) if cs else (None, None)
    out, part = _twice(lambda: cb._conv3x3_launch(x, w, skip, ws, stats))
    ref = cb.conv3x3_stats_plain(x, w, skip, ws, stats)
    what = f"K1 {B}x{H}x{W} {cin}+{cs}->{cout}"
    scaled_close(out, ref[0], tol=TOL, what=what)
    if stats:
        assert part.shape[:2] == (B, cb._build.load_library("tapconv").tapconv_num_partials(
            0, H, W, cout))
        s, sq = cb._partials_to_sums(part)
        scaled_close(s, ref[1], tol=1e-3, what=f"{what} sum")
        scaled_close(sq, ref[2], tol=1e-3, what=f"{what} sumsq")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cout", K2_CASES)
def test_k2_tiles_match_plain_and_repeat_bitwise(B, H, W, cout):
    """K2 (all four parities of a tile in one block) against its plain
    version; outputs and partials bitwise the same over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * 1000 + H + W + cout)
    x = torch.randn(B, H, W, 64, generator=g, device=dev).to(torch.bfloat16)
    taps = cb.parity_taps((torch.randn(3, 3, 64, cout, generator=g, device=dev) / 24)
                          .to(torch.bfloat16))
    out, part = _twice(lambda: cb._upconv_launch(x, taps))
    ref = cb.upconv3x3_stats_plain(x, taps)
    what = f"K2 {B}x{H}x{W} 64->{cout}"
    scaled_close(out, ref[0], tol=TOL, what=what)
    s, sq = cb._partials_to_sums(part)
    scaled_close(s, ref[1], tol=1e-3, what=f"{what} sum")
    scaled_close(sq, ref[2], tol=1e-3, what=f"{what} sumsq")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_k1_k2_refuse_what_they_do_not_take():
    """A CUDA tensor reaches K1 / K2 or an error, never the plain version: a
    Cin or Cout the kernels are not built for, a skip of another width or
    beside the image conv, f32 operands and K2 at Cin 32 all raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")

    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(s, dtype=dtype, device=dev)

    before = dict(cb.LAUNCHES)
    for bad in (lambda: cb.conv3x3_stats(z(2, 8, 16, 16), z(3, 3, 16, 32)),
                lambda: cb.conv3x3_stats(z(2, 8, 16, 32), z(3, 3, 32, 48)),
                lambda: cb.conv3x3_stats(z(2, 8, 16, 3), z(3, 3, 3, 32)),
                lambda: cb.conv3x3_stats(z(2, 8, 16, 64), z(3, 3, 64, 64), z(2, 8, 16, 32),
                                         z(3, 3, 32, 64)),
                lambda: cb.conv3x3_stats(z(2, 8, 16, 1), z(3, 3, 1, 32), z(2, 8, 16, 1),
                                         z(3, 3, 1, 32)),
                lambda: cb.conv3x3_stats(z(2, 8, 16, 32, dtype=torch.float32),
                                         z(3, 3, 32, 32, dtype=torch.float32)),
                lambda: cb.upconv3x3_stats(z(2, 8, 16, 32), z(4, 4, 32, 32)),
                lambda: cb.upconv3x3_stats(z(2, 8, 16, 64), z(4, 4, 64, 16))):
        with pytest.raises(ValueError):
            bad()
    assert cb.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode"])
def test_k1_k2_eval_forwards_take_flips_and_refuse_strided_views(grad_mode):
    """The eval step's forwards: K1 and K2 through their autograd Functions
    under ``no_grad`` / ``inference_mode`` at the ragged eval batch 13, on
    flipped inputs (``torch.flip`` copies, so contiguous) against the plain
    versions; a strided view of the same data raises instead of being read
    with strides the kernels do not expect."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(5)

    def r(*s):
        return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)

    x, w, u, k3 = r(13, 24, 24, 32), r(3, 3, 32, 64), r(13, 12, 12, 64), r(3, 3, 64, 32)
    mode = torch.no_grad if grad_mode == "no_grad" else torch.inference_mode
    with mode():
        for dims in ((), (2,), (1,), (1, 2)):
            xf, uf = (torch.flip(x, dims), torch.flip(u, dims)) if dims else (x, u)
            got = cb.conv3x3_bn_stats(xf, w)
            scaled_close(got[0], cb.conv3x3_stats_plain(xf, w)[0], tol=TOL, what=f"K1 {dims}")
            up = cb.upconv3x3_bn_stats(uf, k3)
            scaled_close(up[0], cb.upconv3x3_stats_plain(uf, cb.parity_taps(k3))[0], tol=TOL,
                         what=f"K2 {dims}")
        before = dict(cb.LAUNCHES)
        for bad in (lambda: cb.conv3x3_stats(x.transpose(1, 2), w),
                    lambda: cb.upconv3x3_stats(u.transpose(1, 2), cb.parity_taps(k3))):
            with pytest.raises(ValueError, match="contiguous"):
                bad()
        assert cb.LAUNCHES == before


#: (B, H, W, cotangent channels, Cin) of K3, on dx's grid (g is 2H x 2W):
#: ragged tilings of the 16 x 16 (Cin 32) and 8 x 16 (Cin 64) tiles, B = 1
#: to 11, both channel counts on each side, the path's 112 x 112 and 224 x 224
K3_CASES = [(1, 13, 21, 32, 64), (3, 20, 36, 32, 32), (2, 1, 40, 64, 64), (11, 57, 45, 32, 64),
            (1, 112, 112, 32, 64), (2, 224, 224, 64, 32), (5, 7, 9, 64, 32), (7, 57, 45, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cg,cin", K3_CASES)
def test_k3_tiles_match_plain_and_repeat_bitwise(B, H, W, cg, cin):
    """K3 (the four parity sub-grids of g as the sources of K1's body)
    against its plain version; dx bitwise the same over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * 1000 + H + W + cg + cin)
    gy = torch.randn(B, 2 * H, 2 * W, cg, generator=g, device=dev).to(torch.bfloat16)
    taps = cb.parity_taps((torch.randn(3, 3, cin, cg, generator=g, device=dev) / (3 * cg ** 0.5))
                          .to(torch.bfloat16))
    dx, dx2 = cb.upconv3x3_dx(gy, taps), cb.upconv3x3_dx(gy, taps)
    assert torch.equal(dx, dx2)
    scaled_close(dx, cb.upconv3x3_dx_plain(gy, taps), tol=TOL, what=f"K3 {B}x{H}x{W} {cg}->{cin}")
    torch.cuda.synchronize()


#: (B, H, W, Cin, Cout, up2) of C1, on x's grid: Cin 1 and 32 (3x3), 64 on
#: both tap sets, both Couts (64: two 32-channel slices per tile), ragged
#: tilings of the 8 x 16 (16 x 16 at Cin 1) tiles, B = 1 to 11, the path's
#: 224 x 224 (Cin 1) and 112 x 112 (Up2)
C1_CASES = [(3, 13, 21, 1, 32, False), (1, 224, 224, 1, 64, False), (11, 57, 45, 1, 32, False),
            (2, 20, 36, 32, 32, False), (1, 1, 40, 32, 64, False), (3, 13, 21, 64, 64, False),
            (2, 10, 18, 64, 32, True), (1, 112, 112, 64, 32, True), (5, 57, 45, 64, 64, True),
            (7, 13, 21, 64, 32, True), (1, 1, 40, 64, 32, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cin,cout,up2", C1_CASES)
def test_c1_tiles_match_plain_and_repeat_bitwise(B, H, W, cin, cout, up2):
    """C1 against its plain version at tilings that stress the persistent
    grid, the halo copies and the channel slices; dk and the per-block
    partials bitwise the same over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * 1000 + H + W + cin + cout + up2)
    s = 2 if up2 else 1
    x = torch.randn(B, H, W, cin, generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn(B, s * H, s * W, cout, generator=g, device=dev).to(torch.bfloat16)
    (dk, part), (dk2, part2) = cb._dw_launch(x, gy, up2), cb._dw_launch(x, gy, up2)
    assert torch.equal(dk, dk2) and torch.equal(part, part2)
    assert part.shape[1:] == dk.shape
    scaled_close(dk, cb.conv_dw_taps_plain(x, gy, up2), tol=DK_TOL,
                 what=f"C1 {B}x{H}x{W} {cin}->{cout} up2={up2}")
    torch.cuda.synchronize()


#: (B, H, W, Cin, Cout, skip) of C2: every (Cin, Cout) in {32, 64}^2, B 1
#: and 5, ragged tilings of the 8 x 16 and 16 x 16 tiles (13 x 21, 20 x 36,
#: 57 x 45, 9 x 40, 1 x 40, 30 x 29), the path's 112 x 112 and 224 x 224, and
#: skip convs as two launches on the same cotangent
C2_CASES = [(1, 13, 21, 32, 32, False), (5, 20, 36, 32, 64, False), (1, 57, 45, 64, 32, False),
            (5, 9, 40, 64, 64, False), (5, 1, 40, 64, 64, False), (1, 224, 224, 32, 32, False),
            (1, 112, 112, 64, 64, True), (5, 30, 29, 32, 32, True), (1, 13, 21, 64, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cin,cout,skip", C2_CASES)
def test_c2_tiles_match_plain_and_repeat_bitwise(B, H, W, cin, cout, skip):
    """C2 against its plain version at tilings that stress the persistent
    grid, the halo copies and the warp roles (32/32: dx and dk on separate
    warps, two blocks per SM; 32/64: 16-row tiles); a skip conv is one launch
    per input, together the backward of the conv over the channel concat. dx
    and dk bitwise the same over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * 1000 + H + W + cin + cout + skip)
    nin = 2 if skip else 1

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(torch.bfloat16)

    xs = [r(B, H, W, cin) for _ in range(nin)]
    ws = [r(3, 3, cin, cout, scale=(9 * cin * nin) ** -0.5) for _ in range(nin)]
    gy = r(B, H, W, cout)
    got = []
    for x, w in zip(xs, ws):
        (dx, dk), (dx2, dk2) = cb.conv3x3_bwd_fused(x, w, gy), cb.conv3x3_bwd_fused(x, w, gy)
        assert torch.equal(dx, dx2) and torch.equal(dk, dk2)
        assert dx.dtype == torch.bfloat16 and dk.dtype == torch.float32
        got.append((dx, dk))
    pdx, pdk = cb.conv3x3_bwd_fused_plain(torch.cat(xs, -1), torch.cat(ws, 2), gy)
    what = f"C2 {B}x{H}x{W} {nin}x{cin}->{cout}"
    scaled_close(torch.cat([d for d, _ in got], -1), pdx, tol=TOL, what=f"{what} dx")
    scaled_close(torch.cat([k for _, k in got], 2), pdk, tol=DK_TOL, what=f"{what} dk")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_k3_refuses_what_it_does_not_take():
    """A CUDA tensor reaches K3 or an error, never the plain version: channel
    counts outside {32, 64} on either side, an odd cotangent grid, taps of
    another shape and f32 operands all raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")

    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(s, dtype=dtype, device=dev)

    before = dict(cb.LAUNCHES)
    for bad in (lambda: cb.upconv3x3_dx(z(2, 16, 32, 48), z(4, 4, 64, 48)),
                lambda: cb.upconv3x3_dx(z(2, 16, 32, 32), z(4, 4, 16, 32)),
                lambda: cb.upconv3x3_dx(z(2, 15, 32, 32), z(4, 4, 64, 32)),
                lambda: cb.upconv3x3_dx(z(2, 16, 32, 32), z(4, 4, 64, 64)),
                lambda: cb.upconv3x3_dx(z(2, 16, 32, 32), z(3, 4, 64, 32)),
                lambda: cb.upconv3x3_dx(z(2, 16, 32, 32, dtype=torch.float32),
                                        z(4, 4, 64, 32, dtype=torch.float32))):
        with pytest.raises(ValueError):
            bad()
    assert cb.LAUNCHES == before


@pytest.mark.gpu
def test_supcon_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for M, d, labels in ((12, 64, True), (37, 256, False), (90, 256, True)):
        z = torch.nn.functional.normalize(torch.randn(M, d, generator=g, device=dev), dim=1)
        if labels:
            y = torch.randint(0, 3, (M,), generator=g, device=dev)
            pos = (y[:, None] == y[None, :]).float()
        else:
            pos = torch.eye(M, device=dev).roll(M // 2, 1)
        off = 1.0 - torch.eye(M, device=dev)
        code = supcon.pair_code(pos * off, (1.0 - pos) * off)
        got = supcon.supcon_loss(z, code, 0.07)
        ref = supcon.supcon_loss_plain(z, code, 0.07)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
        gs = torch.full((1,), 0.5, device=dev)
        dz = supcon.supcon_dz(z, code, got[1], got[2], gs, 0.07)
        dz_ref = supcon.supcon_dz_plain(z, code, ref[1], ref[2], gs, 0.07)
        scaled_close(dz, dz_ref, tol=1e-4)
    torch.cuda.synchronize()


#: (M, d, masks) of D1/D2: ragged anchor counts (not multiples of the 16-row
#: tile or the 32-column chunk), the prostate dense hook's 480 and a
#: multi-chunk 2048 (slices of 256 columns), widths 64 / 256 / 512 and one
#: that is not a multiple of 4 (4-byte copies)
SUPCON_CASES = [(37, 64, "labels"), (181, 256, "self"), (479, 512, "labels"),
                (480, 256, "self"), (2048, 256, "labels"), (96, 100, "labels")]


def _supcon_inputs(M, d, masks, seed):
    """z [M, d] and a pair code with three edge rows: row 0 without
    positives, row 1 without any mask, row 2 masked only where its
    similarity is negative (its stabiliser is the -0 clamp)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.nn.functional.normalize(torch.randn(M, d, generator=g, device=dev), dim=1)
    if masks == "labels":
        y = torch.randint(0, 3, (M,), generator=g, device=dev)
        pos = (y[:, None] == y[None, :]).float()
    else:
        pos = torch.eye(M, device=dev).roll(M // 2, 1)
    off = 1.0 - torch.eye(M, device=dev)
    code = supcon.pair_code(pos * off, (1.0 - pos) * off)
    code[0] &= 2
    code[1] = 0
    code[2] *= (z[2] @ z.T < 0).to(torch.uint8)
    return z, code


@pytest.mark.gpu
@pytest.mark.parametrize("M,d,masks", SUPCON_CASES)
def test_supcon_tiles_match_plain_and_repeat_bitwise(M, d, masks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    z, code = _supcon_inputs(M, d, masks, seed=M + d)
    assert int(code[2].sum()) > 0
    got = supcon.supcon_loss(z, code, 0.07)
    ref = supcon.supcon_loss_plain(z, code, 0.07)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
    assert float(got[2][0]) == 0
    gs = torch.full((1,), 0.5, device=z.device)
    dz = supcon.supcon_dz(z, code, got[1], got[2], gs, 0.07)
    dz_ref = supcon.supcon_dz_plain(z, code, ref[1], ref[2], gs, 0.07)
    scaled_close(dz, dz_ref, tol=1e-4)
    again = supcon.supcon_loss(z, code, 0.07)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(dz, supcon.supcon_dz(z, code, got[1], got[2], gs, 0.07))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_supcon_refuses_above_its_capacity():
    """The capacity is the 32-bit pair index's (M^2 < 2^31) at every width
    the kernels take; one anchor more raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for d in (1, 64, 256, 512):
        assert supcon._max_anchors(d) == supcon.MAX_ANCHORS
    assert supcon._max_anchors(supcon.MAX_DIM + 1) == 0
    dev = torch.device("cuda")
    M = supcon.MAX_ANCHORS + 1
    z = torch.zeros(M, 64, device=dev)
    code = torch.zeros(M, M, dtype=torch.uint8, device=dev)
    one = torch.zeros(M, device=dev)
    before = dict(supcon.LAUNCHES)
    with pytest.raises(ValueError):
        supcon.supcon_loss(z, code, 0.07)
    with pytest.raises(ValueError):
        supcon.supcon_dz(z, code, one, one, torch.ones(1, device=dev), 0.07)
    with pytest.raises(ValueError):
        supcon.supcon_loss(torch.zeros(8, supcon.MAX_DIM + 1, device=dev),
                           torch.zeros(8, 8, dtype=torch.uint8, device=dev), 0.07)
    assert supcon.LAUNCHES == before
    del code
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_conv_bwd_kernels_match_plain():
    """C1 (3x3 taps at Cin 1 and 32, the Up2 parity taps) and C2 (with and
    without a ragged edge) against their plain versions on the same bf16
    operands: dk is f32 on both sides (sums of at most ~2k exact products in
    another order), dx one bf16 rounding on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    for cin, cout in ((1, 32), (32, 64)):
        x, gy = r(3, 13, 21, cin), r(3, 13, 21, cout)
        scaled_close(cb.conv_dw_taps(x, gy), cb.conv_dw_taps_plain(x, gy), tol=DK_TOL,
                     what=f"C1 3x3 Cin {cin}")
    xu, gu = r(2, 10, 18, 64), r(2, 20, 36, 32)
    scaled_close(cb.conv_dw_taps(xu, gu, up2=True), cb.conv_dw_taps_plain(xu, gu, up2=True),
                 tol=DK_TOL, what="C1 Up2")
    for cin, cout, H, W in ((32, 64, 16, 32), (64, 32, 13, 21), (32, 32, 9, 40)):
        x, gy, w = r(2, H, W, cin), r(2, H, W, cout), r(3, 3, cin, cout) * 0.05
        (dx, dk), (pdx, pdk) = cb.conv3x3_bwd_fused(x, w, gy), cb.conv3x3_bwd_fused_plain(x, w, gy)
        scaled_close(dx, pdx, tol=TOL, what=f"C2 dx {cin}->{cout}")
        scaled_close(dk, pdk, tol=DK_TOL, what=f"C2 dk {cin}->{cout}")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_conv_bwd_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor reaches C1 / C2 or an error, never the plain version:
    f32 operands, a Cin or Cout outside {32, 64} (C2), a Cin outside
    {1, 32, 64} or other than 64 on the Up2 taps (C1) and a Cout the
    kernels are not built for all raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")

    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(s, dtype=dtype, device=dev)

    before = dict(cb.LAUNCHES)
    with pytest.raises(ValueError):
        cb.conv_dw_taps(z(2, 8, 16, 32, dtype=torch.float32), z(2, 8, 16, 32, dtype=torch.float32))
    with pytest.raises(ValueError):
        cb.conv_dw_taps(z(2, 8, 16, 32), z(2, 8, 16, 48))
    with pytest.raises(ValueError):
        cb.conv_dw_taps(z(2, 8, 16, 32), z(2, 8, 16, 32), up2=True)
    for cin, up2 in ((16, False), (3, False), (1, True), (32, True), (48, True)):
        with pytest.raises(ValueError):
            cb.conv_dw_taps(z(2, 8, 16, cin), z(2, 16 if up2 else 8, 32 if up2 else 16, 32),
                            up2=up2)
    for cin, cout in ((24, 32), (16, 32), (48, 64), (1, 32), (128, 64), (32, 16), (64, 128)):
        with pytest.raises(ValueError):
            cb.conv3x3_bwd_fused(z(2, 8, 16, cin), z(3, 3, cin, cout), z(2, 8, 16, cout))
    with pytest.raises(ValueError):
        cb.conv3x3_bwd_fused(z(2, 8, 16, 32), z(3, 3, 32, 32), z(2, 8, 12, 32))
    with pytest.raises(ValueError):
        cb.conv3x3_bwd_fused(z(2, 8, 16, 32, dtype=torch.float32),
                             z(3, 3, 32, 32, dtype=torch.float32),
                             z(2, 8, 16, 32, dtype=torch.float32))
    assert cb.LAUNCHES == before


@pytest.mark.gpu
def test_iic_kernels_match_plain():
    """E1 and E2 on ragged images (20 x 36: not whole 16 x 16 tiles), every
    padding, both feature dtypes, the widths the kernels are built for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for C, S, pad, dtype in ((32, 5, 1, torch.bfloat16), (8, 3, 0, torch.float32),
                             (16, 5, 2, torch.bfloat16), (32, 2, 2, torch.float32)):
        f1, f2 = (torch.randn(2, 20, 36, C, generator=g, device=dev).to(dtype)
                  for _ in range(2))
        w = torch.randn(C, S * 20, generator=g, device=dev) * 0.3
        b = torch.randn(S * 20, generator=g, device=dev) * 0.1
        kw = dict(num_subheads=S, num_clusters=20, padding=pad)
        what = f"C={C} S={S} pad={pad} {dtype}"
        scaled_close(iic.iic_joints(f1, f2, w, b, **kw), iic.iic_joints_plain(f1, f2, w, b, **kw),
                     tol=1e-5, what=f"E1 {what}")
        jbar = torch.randn(S, 2 * pad + 1, 2 * pad + 1, 20, 20, generator=g, device=dev)
        got = iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)
        ref = iic.iic_joints_bwd_plain(f1, f2, w, b, jbar, **kw)
        ftol = TOL if dtype == torch.bfloat16 else 1e-5
        for name, a, r, tol in zip(("df1", "df2", "dw", "db"), got, ref,
                                   (ftol, ftol, DK_TOL, DK_TOL)):
            assert a.dtype == r.dtype
            scaled_close(a, r, tol=tol, what=f"E2 {name} {what}")
    torch.cuda.synchronize()


def _loss_cotangent(f1, f2, w, b, S, pad):
    """The dense hook's own cotangent of the raw joints: the gradient of 0.05
    x the summed per-subhead IIC losses (min-shift normalized at padding > 0)."""
    from contrastyou_tpu_torch.losses.discrete_mi import iid_loss_from_raw_joints
    raw = iic.iic_joints_plain(f1, f2, w, b, num_subheads=S, num_clusters=20,
                               padding=pad).requires_grad_()
    B, H, W = f1.shape[:3]
    (0.05 * iid_loss_from_raw_joints(raw, padding=pad, count=B * H * W).sum()).backward()
    return raw.grad


#: (B, H, W, C, S, padding, features) of E1: ragged images (20 x 36 and 17 x
#: 33 are not whole 16 x 16 tiles), every padding, width and feature dtype,
#: S = 1 and S * K = 160
E1_CASES = [(2, 20, 36, 32, 5, 1, torch.bfloat16), (2, 17, 33, 16, 8, 1, torch.bfloat16),
            (2, 17, 33, 8, 1, 0, torch.bfloat16), (2, 20, 36, 32, 5, 0, torch.bfloat16),
            (2, 20, 36, 16, 5, 2, torch.bfloat16), (1, 17, 33, 32, 8, 2, torch.bfloat16),
            (2, 20, 36, 8, 3, 0, torch.float32), (2, 17, 33, 16, 1, 1, torch.float32),
            (2, 20, 36, 32, 8, 1, torch.float32), (2, 17, 33, 32, 2, 2, torch.float32),
            (1, 20, 36, 8, 5, 2, torch.float32), (2, 17, 33, 32, 5, 0, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,C,S,pad,dtype", E1_CASES)
def test_e1_matches_plain_and_repeats_bitwise(B, H, W, C, S, pad, dtype):
    """E1 (split-bf16 operands on the tensor cores) against its plain
    version run in float64, within 1e-5 of the largest raw joint; two
    launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    f1, f2 = (torch.randn(B, H, W, C, generator=g, device=dev).to(dtype) for _ in range(2))
    w = torch.randn(C, S * 20, generator=g, device=dev) * 0.3
    b = torch.randn(S * 20, generator=g, device=dev) * 0.1
    kw = dict(num_subheads=S, num_clusters=20, padding=pad)
    got, again = iic.iic_joints(f1, f2, w, b, **kw), iic.iic_joints(f1, f2, w, b, **kw)
    ref = iic.iic_joints_plain(f1, f2, w.double(), b.double(), **kw)
    what = f"E1 {B}x{H}x{W} C={C} S={S} pad={pad} {dtype}"
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, again), f"{what}: two launches differ"
    scaled_close(got.double(), ref, tol=1e-5, what=what)
    torch.cuda.synchronize()


#: (B, H, W, C, S, padding, features, cotangent) of E2: ragged images (20 x 36
#: and 17 x 33 are not whole 16 x 16 or 8 x 16 tiles), every padding, width and
#: feature dtype, S = 1 and S * K = 160, the loss cotangent at every padding
#: (at padding 0 its joint is divided by the pixel count, not min-shift
#: normalized, and db sums terms that cancel over every pixel).
E2_CASES = [
    (2, 20, 36, 32, 5, 1, torch.bfloat16, "loss"), (2, 17, 33, 32, 5, 1, torch.bfloat16, "randn"),
    (2, 17, 33, 8, 1, 0, torch.bfloat16, "randn"), (2, 20, 36, 16, 8, 2, torch.bfloat16, "loss"),
    (3, 17, 33, 32, 5, 2, torch.bfloat16, "randn"), (2, 17, 33, 16, 5, 0, torch.bfloat16, "randn"),
    (2, 17, 33, 32, 8, 0, torch.float32, "randn"), (1, 17, 33, 8, 5, 2, torch.float32, "loss"),
    (2, 20, 36, 16, 1, 1, torch.float32, "loss"), (2, 20, 36, 32, 8, 1, torch.float32, "randn"),
    (2, 17, 33, 32, 2, 2, torch.float32, "randn"), (1, 17, 33, 8, 3, 1, torch.bfloat16, "loss"),
    (2, 17, 33, 32, 5, 0, torch.bfloat16, "loss"), (2, 20, 36, 8, 3, 0, torch.float32, "loss"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,C,S,pad,dtype,cot", E2_CASES)
def test_e2_matches_plain_and_repeats_bitwise(B, H, W, C, S, pad, dtype, cot):
    """E2 (split-bf16 operands on the tensor cores) against its plain version
    run in float64 (f32 itself strays from it by up to ~2e-5 of max |db| at
    padding 0 on the loss cotangent), at the file's tolerances: feature
    gradients TOL in bf16 and 1e-5 of the largest value in f32 (the reference
    rounded to the features' dtype), dW and db DK_TOL. Two launches on the
    same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    f1, f2 = (torch.randn(B, H, W, C, generator=g, device=dev).to(dtype) for _ in range(2))
    w = torch.randn(C, S * 20, generator=g, device=dev) * 0.3
    b = torch.randn(S * 20, generator=g, device=dev) * 0.1
    td = 2 * pad + 1
    jbar = (_loss_cotangent(f1, f2, w, b, S, pad) if cot == "loss"
            else torch.randn(S, td, td, 20, 20, generator=g, device=dev))
    kw = dict(num_subheads=S, num_clusters=20, padding=pad)
    got = iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)
    again = iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)
    ref = iic.iic_joints_bwd_plain(*(x.double() for x in (f1, f2, w, b, jbar)), **kw)
    ref = (ref[0].to(dtype), ref[1].to(dtype), *ref[2:])
    ftol = TOL if dtype == torch.bfloat16 else 1e-5
    what = f"C={C} S={S} pad={pad} {dtype} {cot}"
    for name, a, a2, r, tol, want in zip(("df1", "df2", "dw", "db"), got, again, ref,
                                         (ftol, ftol, DK_TOL, DK_TOL),
                                         (dtype, dtype, torch.float32, torch.float32)):
        assert a.dtype == want and a.shape == r.shape
        assert torch.equal(a, a2), f"E2 {name} {what}: two launches differ"
        scaled_close(a, r, tol=tol, what=f"E2 {name} {what}")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_iic_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor reaches E1 / E2 or an error, never the plain version: a
    width, cluster count or padding the kernels are not built for, fp16,
    mixed dtypes and a non-contiguous map all raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")

    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(s, dtype=dtype, device=dev)

    def call(f1, f2, S=2, K=20, pad=1, C=None):
        C = C or f1.shape[-1]
        return iic.iic_joints(f1, f2, z(C, S * K, dtype=torch.float32),
                              z(S * K, dtype=torch.float32), num_subheads=S,
                              num_clusters=K, padding=pad)

    before = dict(iic.LAUNCHES)
    for bad in (lambda: call(z(1, 8, 8, 24), z(1, 8, 8, 24)),
                lambda: call(z(1, 8, 8, 32), z(1, 8, 8, 32), K=10),
                lambda: call(z(1, 8, 8, 32), z(1, 8, 8, 32), pad=3),
                lambda: call(z(1, 8, 8, 32), z(1, 8, 8, 32), S=9),
                lambda: call(z(1, 8, 8, 32, dtype=torch.float16), z(1, 8, 8, 32, dtype=torch.float16)),
                lambda: call(z(1, 8, 8, 32), z(1, 8, 8, 32, dtype=torch.float32)),
                lambda: call(z(1, 8, 16, 32)[:, :, ::2], z(1, 8, 8, 32)),
                lambda: iic.iic_joints_bwd(z(1, 8, 8, 32), z(1, 8, 8, 32),
                                           z(32, 40, dtype=torch.float32),
                                           z(40, dtype=torch.float32),
                                           z(2, 1, 1, 20, 20, dtype=torch.float32),
                                           num_subheads=2, num_clusters=20, padding=1)):
        with pytest.raises(ValueError):
            bad()
    assert iic.LAUNCHES == before


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """On the CPU the wrappers never reach a kernel; the checks that guard
    the kernel launch raise on the device, dtype and channel count."""
    with pytest.raises(ValueError):
        cb._cuda_check("k", torch.zeros(2, dtype=torch.bfloat16))
    f = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        iic._cuda_check("iic", f, f, torch.zeros(32, 40), torch.zeros(40), 2, 20, 1)
    assert iic.iic_joints(f, f, torch.zeros(32, 40), torch.zeros(40), num_subheads=2,
                          num_clusters=20, padding=1).shape == (2, 3, 3, 20, 20)
    assert cb.conv3x3_stats(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 5))[0].shape \
        == (1, 4, 4, 5)


def test_library_yardsticks_compute_the_kernels_functions():
    """chip_smoke.py times one cuDNN call beside each conv kernel; on the CPU
    (f32) each call computes the plain version's function: K1 a conv over the
    skip concat, K2 a stride-2 transposed conv with the parity taps, K3 its
    adjoint."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(0)
    x, skip = torch.randn(2, 9, 11, 8, generator=g), torch.randn(2, 9, 11, 4, generator=g)
    w, ws = torch.randn(3, 3, 8, 6, generator=g), torch.randn(3, 3, 4, 6, generator=g)
    ref = cb.conv3x3_stats_plain(x, w, skip, ws)[0]
    torch.testing.assert_close(smoke.library_calls(x, w, skip, ws)[1], ref, rtol=1e-5, atol=1e-5)
    taps = cb.parity_taps(torch.randn(3, 3, 8, 6, generator=g))
    torch.testing.assert_close(smoke.library_calls(x, None, taps=taps)[1],
                               cb.upconv3x3_stats_plain(x, taps)[0], rtol=1e-5, atol=1e-5)
    gy = torch.randn(2, 18, 22, 6, generator=g)
    torch.testing.assert_close(smoke.library_calls(None, None, taps=taps, g=gy)[1],
                               cb.upconv3x3_dx_plain(gy, taps), rtol=1e-5, atol=1e-5)


def test_backward_yardsticks_compute_c1_c2_functions():
    """chip_smoke.py times one cuDNN ``convolution_backward`` beside C1 and
    C2; on the CPU (f32) each call computes the plain version's function: C1
    the weight gradient of the 3x3 conv and of the stride-2 transposed conv
    (as the 16 parity taps), C2 the input and weight gradients of a conv,
    over the channel concat for a skip conv."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(1)
    x, skip = torch.randn(2, 9, 11, 8, generator=g), torch.randn(2, 9, 11, 4, generator=g)
    gy = torch.randn(2, 9, 11, 6, generator=g)
    w, ws = torch.randn(3, 3, 8, 6, generator=g), torch.randn(3, 3, 4, 6, generator=g)
    tol = dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(smoke.library_bwd_calls(x, gy)[1], cb.conv_dw_taps_plain(x, gy),
                               **tol)
    gu = torch.randn(2, 18, 22, 6, generator=g)
    torch.testing.assert_close(smoke.library_bwd_calls(x, gu, up2=True)[1],
                               cb.conv_dw_taps_plain(x, gu, up2=True), **tol)
    dx, dk = smoke.library_bwd_calls(x, gy, w)[1]
    pdx, pdk = cb.conv3x3_bwd_fused_plain(x, w, gy)
    torch.testing.assert_close(dx, pdx, **tol)
    torch.testing.assert_close(dk, pdk, **tol)
    dx, dk = smoke.library_bwd_calls(x, gy, w, skip, ws)[1]
    (sdx, sdk), (xdx, xdk) = cb.conv3x3_bwd_fused_plain(skip, ws, gy), (pdx, pdk)
    torch.testing.assert_close(dx, torch.cat([sdx, xdx], -1), **tol)
    torch.testing.assert_close(dk, torch.cat([sdk, xdk], 2), **tol)


def test_iic_bounds_count_the_split_products():
    """chip_smoke.py bounds E1 and E2 by their useful FLOP times the fewest
    products of bf16 pieces their splits need, on the bf16 tensor cores; at
    the udaiic shapes ([5, 224, 224, 32] bf16, S = 5, K = 20) E1's is
    operations-bound: 0.0371 ms at padding 1, 0.0128 at 0, 0.0858 at 2."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    f = torch.empty(5, 224, 224, 32, dtype=torch.bfloat16, device="meta")
    for pad, want in ((1, 0.0371), (0, 0.0128), (2, 0.0858)):
        nbytes = smoke.iic_work(f, 5, 20, pad)["iic_joints"][0]
        ms, by = smoke._bound(nbytes, smoke.e1_split_flops(f, 5, 20, pad), smoke.BF16_FLOPS)
        assert by == "operations" and abs(ms - want) < 1e-4, (pad, ms, by)


def test_profile_step_names_the_hand_kernels():
    """profile_step attributes device events to the port's kernels by their
    CUDA function names: K1, K2 and K3 share the tensor-core body and differ
    in its KIND template argument; C1, C2, E1 and E2 (with its operand
    preparation) have kernels of their own; D1 and D2 share one body."""
    from contrastyou_tpu_torch.profile_step import _hand_kernel
    ns = "void (anonymous namespace)::"
    mma = ns + "tapmma_kernel<{}>((anonymous namespace)::MmaParams)"
    assert _hand_kernel(mma.format("64, 64, 0, 3, 4")) == "K1 conv3x3_stats"
    assert _hand_kernel(mma.format("32, 64, 1, 2, 2")) == "K2 upconv3x3_stats"
    assert _hand_kernel(mma.format("64, 32, 2, 3, 4")) == "K3 upconv3x3_dx"
    assert _hand_kernel(ns + "conv1ch_kernel<32>(__nv_bfloat16 const*)") == "K1 conv3x3_stats"
    params = "((anonymous namespace)::Params)"
    assert _hand_kernel(ns + "dw_mma_kernel<64, true>" + params) == "C1 conv_dw_taps"
    assert _hand_kernel(ns + "dw1ch_kernel<32>" + params) == "C1 conv_dw_taps"
    assert _hand_kernel(ns + "convbwd_kernel<32>" + params) == "C2 conv3x3_bwd_fused"
    geo = "((anonymous namespace)::Geo)"
    e1 = ns + "e1::iic_joints_kernel<__nv_bfloat16, 32, (anonymous namespace)::e1::Plan<2, 1, 2> >"
    assert _hand_kernel(e1 + geo) == "E1 iic_joints"
    assert (_hand_kernel(ns + "e2::iic_joints_bwd_kernel<__nv_bfloat16, 32, 2, 2>(float*)")
            == "E2 iic_joints_bwd")
    assert _hand_kernel(ns + "e2::iic_joints_bwd_prep<2, 3>(float const*)") == "E2 iic_joints_bwd"
    args = "((anonymous namespace)::Args, (anonymous namespace)::Geo)"
    for kind in ("false, 2", "true, 2", "true, 4"):
        assert _hand_kernel(ns + f"supcon_kernel<{kind}>" + args) == "D1/D2 supcon"
    assert _hand_kernel("void at::native::elementwise_kernel<128, 4>") is None


def _unroll_run(unroll: int):
    """The ``semi`` run at full width on 32 x 32 crops (the kernels take the
    narrow levels' 32 and 64 channels), ``unroll`` steps a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from contrastyou_tpu_torch.main import build_semi_run, parse_config
    cfg = parse_config(["-o", "Trainer.name=semi", f"Trainer.unroll_steps={unroll}"])
    return build_semi_run(cfg, device=torch.device("cuda"), raw_size=40, crop=32, n_slices=8)


@pytest.mark.gpu
def test_unrolled_graph_matches_eager_steps():
    """``semi`` at K = 2, three calls (the eager warm-up, a capture and
    replay, a replay: one CUDA graph a call) against six eager steps from
    one seed: the sampled batch indices equal, losses and parameters within
    TOL, the replays' draws not frozen, the launches the eager steps make,
    and ``step`` 6."""
    from contrastyou_tpu_torch.engine.trainer import kernel_launches
    K, calls = 2, 3
    losses, ids, launches = {}, {}, {}
    runs = {}
    for unroll in (1, K):
        run = runs[unroll] = _unroll_run(unroll)
        drawn, draw = [], run.labeled_cache.draw
        run.labeled_cache.draw = lambda g, n, draw=draw, drawn=drawn: (
            drawn.append(draw(g, n)) or drawn[-1])
        for reset in (cb.reset_launch_counts, supcon.reset_launch_counts,
                      iic.reset_launch_counts):
            reset()
        got = [run.step(run.state, run.generator, 0, run.host_rng)
               for _ in range(K * calls if unroll == 1 else calls)]
        losses[unroll] = torch.cat([m["total_loss"].reshape(-1) for m in got])
        ids[unroll] = torch.stack([d[0] for d in drawn])
        launches[unroll] = kernel_launches()
    graph = runs[K].step.graph
    assert graph.replays == calls - 1 and graph.launches_per_graph
    assert torch.equal(ids[1], ids[K]) and not torch.equal(ids[K][2:4], ids[K][4:6])
    scaled_close(losses[K], losses[1], tol=TOL)
    assert launches[1] == launches[K] and runs[K].state.step == runs[1].state.step == K * calls
    for (k, a), b in zip(runs[K].state.model.state_dict().items(),
                         runs[1].state.model.state_dict().values()):
        if a.is_floating_point():
            scaled_close(a, b, tol=TOL)


class _SyncHook(TrainerHook):
    """A hook whose loss reads a value back to the host."""

    def loss(self, ctx, state):
        scale = float(ctx.unlabeled_logits.float().mean().abs() + 1)   # reads back
        return ctx.unlabeled_logits.float().mean() * 0 * scale, state, {}


class _HostCountHook(TrainerHook):
    """A hook that counts its steps on the host."""

    def init_state(self, bundle):
        return {"count": 0}

    def loss(self, ctx, state):
        return ctx.unlabeled_logits.float().mean() * 0, {"count": state["count"] + 1}, {}


@pytest.mark.gpu
@pytest.mark.parametrize("hook,match", [(_SyncHook, "CUDA graph capture of 2 steps failed"),
                                        (_HostCountHook, "a host value")])
def test_unrolled_graph_capture_failure_raises(hook, match):
    """A step that reads back to the host, or keeps host state, cannot be
    replayed: the capture raises naming the path, and the run never falls
    back to eager steps."""
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.steps import build_cached_train_step, init_train_state
    run = _unroll_run(1)
    hooks = [*run.hooks, hook(hook_name="probe")]
    state = init_train_state(ModelBundle(run.state.model, (32, 32, 1)), hooks,
                             run.state.optimizer)
    step = build_cached_train_step(ModelBundle(run.state.model, (32, 32, 1)), hooks,
                                   labeled_cache=run.labeled_cache,
                                   unlabeled_cache=run.unlabeled_cache, unroll=2)
    step(state, run.generator, 0, run.host_rng)             # the eager warm-up
    with pytest.raises(RuntimeError, match=match) as err:
        step(state, run.generator, 0, run.host_rng)
    assert "device-cached semi step" in str(err.value)
    assert step.graph.replays == 0


def _eval_inputs(seed: int, K: int = 2, B: int = 3, S: int = 32):
    """A chunk of K eval batches of B slices on the card (the last batch
    half padded)."""
    g = torch.Generator().manual_seed(seed)
    masks = torch.ones(K, B, dtype=torch.bool)
    masks[-1, B // 2:] = False
    return [x.cuda() for x in (torch.rand(K, B, S, S, 1, generator=g),
                               torch.randint(0, 4, (K, B, S, S), generator=g, dtype=torch.int32),
                               masks)]


@pytest.mark.gpu
def test_eval_graph_matches_eager_chunks():
    """The chunked eval step on the card: the first call the eager warm-up,
    the second captures and replays, the third replays on other inputs;
    each bitwise equal to the eager chunk on the same inputs; one capture,
    the launches of a replay those the capture recorded; a replaced
    parameter recaptures, and the replay then reads the new weights."""
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.steps import build_scanned_eval_step
    from contrastyou_tpu_torch.engine.trainer import kernel_launches
    run = _unroll_run(1)
    model = run.state.model
    scanned = build_scanned_eval_step(ModelBundle(model, (32, 32, 1)))
    graph = scanned.graph
    for seed in range(3):
        x = _eval_inputs(seed)
        before = kernel_launches()
        got = scanned(model, *x)
        after = kernel_launches()
        for a, b in zip(got, graph.body(model, *x)):
            assert torch.equal(a, b), seed
        if seed == 2:
            assert {k: after[k] - before.get(k, 0) for k in graph.launches_per_graph} == \
                graph.launches_per_graph
    assert graph.captures == 1 and graph.replays == 2 and graph.launches_per_graph
    conv = model._Conv1.conv[0]
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 1.5)
    x = _eval_inputs(3)
    for a, b in zip(scanned(model, *x), graph.body(model, *x)):
        assert torch.equal(a, b)
    assert graph.captures == 2


@pytest.mark.gpu
def test_eval_graph_capture_failure_raises():
    """A chunk body that reads a value back cannot be captured: the second
    call raises naming the path; no eager result stands in for the graph."""
    from contrastyou_tpu_torch.engine.graph import EvalGraph
    run = _unroll_run(1)

    def body(model, images, targets, masks):
        return images.sum() * float(images.mean())

    graph = EvalGraph(body, name="the probe eval")
    x = _eval_inputs(0)
    graph(run.state.model, *x)
    with pytest.raises(RuntimeError, match="the probe eval: the CUDA graph capture"):
        graph(run.state.model, *x)
    assert graph.replays == 0
