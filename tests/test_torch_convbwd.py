"""The port's backward kernels C1 (``conv_dw_taps``) and C2
(``conv3x3_bwd_fused``) of contrastyou_tpu_torch/ops/convblock.py held against
the JAX package's Pallas kernels ``plane_conv_dw`` and ``plane_conv_bwd_fused``
(interpret mode), and the batch-96 routing of the conv-block backward against
the JAX routed backward and the port's own einsum backward. On the CPU the
wrappers run their plain versions; the CUDA kernels are held against those in
tests/test_torch_cuda.py.

Tolerances (f32 throughout, so the point is the algorithm): dk rtol 1e-5 /
atol 1e-4 (the same sums of at most 3 x 12 x 10 products of unit normals in
another order; entries reach ~50), dx rtol 1e-5 / atol 1e-5; through the
routed backward with BN statistics folded in, rtol 1e-4 / atol 1e-4 as in
tests/test_torch_convblock.py. Port against port (routed vs einsum) is the
same arithmetic up to summation order: rtol 1e-5 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.ops.pallas import convblock as jcb
from contrastyou_tpu_torch.ops import convblock as cb
from torch_parity import close, t

torch.set_num_threads(1)

DK = dict(rtol=1e-5, atol=1e-4)
DX = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _kernel_routing(monkeypatch):
    """The JAX package's own knobs route its backward through C1 and C2."""
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "1")
    monkeypatch.setenv("CONTRASTYOU_PLANE_DW", "1")
    monkeypatch.setenv("CONTRASTYOU_PLANE_FUSEDBWD", "1")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _planes(a, geo):
    return jcb.to_planes(jnp.asarray(a), jnp.float32, geo)


@pytest.mark.parametrize("cin", [1, 16])
def test_conv_dw_taps_3x3_matches_plane_conv_dw(cin):
    rng = np.random.default_rng(0)
    B, H, W, cout = 3, 12, 10, 8
    x, g = _rand(rng, B, H, W, cin), _rand(rng, B, H, W, cout)
    geo = jcb.pick_geometry(H, W, max(cin, cout), 4)
    ref = jcb.plane_conv_dw(_planes(x, geo), _planes(g, geo), geo, jcb.tap_offsets(geo.rs))
    close(cb.conv_dw_taps(t(x), t(g)), ref, **DK)


def test_conv_dw_taps_up2_matches_plane_conv_dw_on_the_parity_taps():
    """The 16 parity taps of Up2: each parity's 4 taps at the offsets of
    ``_parity_taps``, contracted with the cotangent's parity sub-grid."""
    rng = np.random.default_rng(1)
    B, H, W, cin, cout = 2, 6, 8, 16, 8
    x, g = _rand(rng, B, H, W, cin), _rand(rng, B, 2 * H, 2 * W, cout)
    geo = jcb.pick_geometry(H, W, max(cin, cout), 4)
    zero = jnp.zeros((3, 3, cin, cout), jnp.float32)
    ref = []
    for p in range(4):
        a, b = divmod(p, 2)
        _, offs = jcb._parity_taps(zero, a, b, geo.rs)
        ref.append(jcb.plane_conv_dw(_planes(x, geo), _planes(g[:, a::2, b::2], geo), geo, offs))
    close(cb.conv_dw_taps(t(x), t(g), up2=True), np.concatenate(ref), **DK)


@pytest.mark.parametrize("cin,cout,H,W", [(16, 32, 12, 10), (8, 8, 12, 10),
                                          (32, 16, 12, 10), (8, 16, 9, 13)])
def test_conv3x3_bwd_fused_matches_plane_conv_bwd_fused(cin, cout, H, W):
    """dx and the tap-ordered dk (the JAX entry point un-reverses its
    kernel's taps) on square, ragged and odd sizes."""
    rng = np.random.default_rng(2)
    B = 3
    x, g = _rand(rng, B, H, W, cin), _rand(rng, B, H, W, cout)
    k = _rand(rng, 3, 3, cin, cout, scale=0.2)
    geo = jcb.pick_geometry(H, W, max(cin, cout), 4)
    jdx, jdk = jcb.plane_conv_bwd_fused(_planes(x, geo), jnp.asarray(k), _planes(g, geo), geo)
    dx, dk = cb.conv3x3_bwd_fused(t(x), t(k), t(g))
    close(dx, jcb.from_planes(jdx, H, W, geo), **DX, what="dx")
    close(dk, jdk, **DK, what="dk")


def test_skip_conv_bwd_is_the_fused_bwd_of_the_concat():
    """The skip convs run C2 once per input on the same cotangent: together
    they are the JAX fused backward of one conv over cat([skip, x])."""
    rng = np.random.default_rng(3)
    B, H, W, cx, cs, cout = 2, 8, 12, 16, 16, 32
    x, skip, g = _rand(rng, B, H, W, cx), _rand(rng, B, H, W, cs), _rand(rng, B, H, W, cout)
    k = _rand(rng, 3, 3, cs + cx, cout, scale=0.2)
    geo = jcb.pick_geometry(H, W, cs + cx, 4)
    jdx, jdk = jcb.plane_conv_bwd_fused(_planes(np.concatenate([skip, x], -1), geo),
                                        jnp.asarray(k), _planes(g, geo), geo)
    jdx = np.asarray(jcb.from_planes(jdx, H, W, geo))
    kt = t(k)
    dxs, dks = cb.conv3x3_bwd_fused(t(skip), kt[:, :, :cs], t(g))
    dxx, dkx = cb.conv3x3_bwd_fused(t(x), kt[:, :, cs:], t(g))
    close(dxs, jdx[..., :cs], **DX, what="dskip")
    close(dxx, jdx[..., cs:], **DX, what="dx")
    close(dks, np.asarray(jdk)[:, :, :cs], **DK, what="dk skip")
    close(dkx, np.asarray(jdk)[:, :, cs:], **DK, what="dk x")


def _recording(monkeypatch, name):
    calls = []
    fn = getattr(cb, name)

    def wrapper(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(cb, name, wrapper)
    return calls


@pytest.mark.parametrize("cin", [1, 16])
def test_routed_conv_backward_matches_jax_routed_backward(monkeypatch, cin):
    """With the port's threshold at the test batch, the conv backward takes
    C2 (Cin >= 8) or K1 dx + C1 (Cin 1), as JAX ``_plane_conv_bwd`` does
    with its knobs on: dx and dW of ``conv3x3_bn_stats`` == those of JAX
    ``plane_conv_stats`` (statistics' cotangents folded in)."""
    monkeypatch.setattr(cb, "BWD_KERNEL_MIN_BATCH", 2)
    fused = _recording(monkeypatch, "conv3x3_bwd_fused")
    dw = _recording(monkeypatch, "conv_dw_taps")
    rng = np.random.default_rng(4)
    B, H, W, cout = 2, 8, 12, 16
    x, k = _rand(rng, B, H, W, cin), _rand(rng, 3, 3, cin, cout, scale=0.2)
    gy, gs = _rand(rng, B, H, W, cout), _rand(rng, B, cout)
    gq = _rand(rng, B, cout, scale=0.01)
    geo = jcb.pick_geometry(H, W, max(cin, cout), 4)
    mask = jcb.border_mask(H, W, geo)
    gyp = _planes(gy, geo)

    def jloss(xp, kk):
        out, s, sq = jcb.plane_conv_stats(xp, kk, mask, H, W, geo)
        return jnp.sum(out * gyp) + jnp.sum(s * gs) + jnp.sum(sq * gq)

    jdx, jdk = jax.grad(jloss, (0, 1))(_planes(x, geo), jnp.asarray(k))
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    out, s, sq = cb.conv3x3_bn_stats(xt, kt)
    ((out * t(gy)).sum() + (s * t(gs)).sum() + (sq * t(gq)).sum()).backward()
    close(xt.grad, jcb.from_planes(jdx, H, W, geo), **GRAD, what="dx")
    close(kt.grad, jdk, **GRAD, what="dW")
    assert (len(fused), len(dw)) == ((1, 0) if cin >= 8 else (0, 1))


def test_routed_upconv_backward_matches_jax_upconv_plane(monkeypatch):
    """Up2 from the threshold: the parity taps' gradient through C1 ==
    JAX ``upconv_plane`` with ``plane_conv_dw`` routed."""
    monkeypatch.setattr(cb, "BWD_KERNEL_MIN_BATCH", 2)
    dw = _recording(monkeypatch, "conv_dw_taps")
    rng = np.random.default_rng(5)
    B, H, W, cin, cout = 2, 6, 8, 16, 8
    x, k3 = _rand(rng, B, H, W, cin), _rand(rng, 3, 3, cin, cout, scale=0.2)
    gy, gs = _rand(rng, B, 2 * H, 2 * W, cout), _rand(rng, B, cout)
    gq = _rand(rng, B, cout, scale=0.01)
    gi = jcb.pick_geometry(H, W, max(cin, cout), 4)
    go = jcb.pick_geometry(2 * H, 2 * W, cout, 4)

    def jloss(xx, kk):
        out, s, sq = jcb.upconv_plane(jcb.to_planes(xx, jnp.float32, gi), kk, H, W, gi, go)
        out = jcb.from_planes(out, 2 * H, 2 * W, go)
        return jnp.sum(out * gy) + jnp.sum(s * gs) + jnp.sum(sq * gq)

    jdx, jdk = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(k3))
    xt, kt = t(x).requires_grad_(), t(k3).requires_grad_()
    out, s, sq = cb.upconv3x3_bn_stats(xt, kt)
    ((out * t(gy)).sum() + (s * t(gs)).sum() + (sq * t(gq)).sum()).backward()
    close(xt.grad, jdx, **GRAD, what="dx")
    close(kt.grad, jdk, **GRAD, what="dk3")
    assert len(dw) == 1


def _grads(fn, *args):
    args = [t(a).requires_grad_() for a in args]
    out, s, sq = fn(*args)
    (out.square().sum() + s.sum() + 0.1 * sq.sum()).backward()
    return [a.grad.clone() for a in args]


def test_routed_backward_equals_the_einsum_backward(monkeypatch):
    """At the threshold batch the gradients of ``conv3x3_bn_stats`` (with a
    skip, and at Cin 1) and ``upconv3x3_bn_stats`` equal those of the path
    below it (K1 dx + per-tap einsums); only the routing differs."""
    rng = np.random.default_rng(6)
    B = cb.BWD_KERNEL_MIN_BATCH
    x1, k1 = _rand(rng, B, 6, 6, 1), _rand(rng, 3, 3, 1, 8, scale=0.3)
    x, skip = _rand(rng, B, 6, 6, 8), _rand(rng, B, 6, 6, 8)
    k, ks = _rand(rng, 3, 3, 8, 8, scale=0.1), _rand(rng, 3, 3, 8, 8, scale=0.1)
    xu, k3 = _rand(rng, B, 3, 3, 8), _rand(rng, 3, 3, 8, 8, scale=0.1)
    cases = [(cb.conv3x3_bn_stats, (x1, k1)), (cb.conv3x3_bn_stats, (x, k, skip, ks)),
             (cb.upconv3x3_bn_stats, (xu, k3))]
    fused = _recording(monkeypatch, "conv3x3_bwd_fused")
    dw = _recording(monkeypatch, "conv_dw_taps")
    routed = [_grads(fn, *a) for fn, a in cases]
    assert (len(fused), len(dw)) == (2, 2)
    monkeypatch.setattr(cb, "BWD_KERNEL_MIN_BATCH", B + 1)
    for (fn, a), got in zip(cases, routed):
        for g_routed, g_einsum in zip(got, _grads(fn, *a)):
            close(g_routed, g_einsum, **DX)
    assert (len(fused), len(dw)) == (2, 2)
