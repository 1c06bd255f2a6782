"""The port's conv-block kernels (contrastyou_tpu_torch/ops/convblock.py) held
against the JAX package: the Pallas plane kernels in interpret mode and the
XLA formulation. On the CPU the port's wrappers run their plain versions; the
CUDA kernels themselves are held against those in tests/test_torch_cuda.py.

Tolerances (f32 throughout, so the point is the algorithm): forward values
and per-sample statistics rtol 1e-5 / atol 1e-4 (the same sums in another
order; the statistics sum ~400 products), gradients rtol 1e-4 / atol 1e-4
(one more contraction in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.models.unet import ConvBlock as JConvBlock
from contrastyou_tpu.models.unet import UpConv as JUpConv
from contrastyou_tpu.models.unet import conv3x3_on_upsampled
from contrastyou_tpu.ops.pallas import convblock as jcb
from contrastyou_tpu_torch.models.unet import ConvBlock, UpConv
from contrastyou_tpu_torch.ops import convblock as cb
from torch_parity import close, hwio, load_block, t

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _planes(x, cmax):
    B, H, W, _ = x.shape
    geo = jcb.pick_geometry(H, W, cmax, 4)
    return jcb.to_planes(jnp.asarray(x), jnp.float32, geo), jcb.border_mask(H, W, geo), geo


def test_conv3x3_stats_matches_pallas_plane_conv_stats():
    """K1's plain version == the Pallas plane conv (interpret mode) in
    forward, per-sample statistics, dx and dW."""
    rng = np.random.default_rng(0)
    B, H, W, cin, cout = 2, 8, 12, 8, 16
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    gy = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    gs = rng.standard_normal((B, cout)).astype(np.float32)
    gq = rng.standard_normal((B, cout)).astype(np.float32) * 0.01
    xp, mask, geo = _planes(x, max(cin, cout))
    gyp = jcb.to_planes(jnp.asarray(gy), jnp.float32, geo)

    def jloss(xp_, k_):
        out, s, sq = jcb.plane_conv_stats(xp_, k_, mask, H, W, geo)
        return jnp.sum(out * gyp) + jnp.sum(s * gs) + jnp.sum(sq * gq), (out, s, sq)

    (_, (jout, js, jsq)), (jdxp, jdk) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(xp, jnp.asarray(k))

    xt = t(x).requires_grad_()
    kt = t(k).requires_grad_()
    out, s, sq = cb.conv3x3_bn_stats(xt, kt)
    ((out * t(gy)).sum() + (s * t(gs)).sum() + (sq * t(gq)).sum()).backward()
    close(out, jcb.from_planes(jout, H, W, geo), **FWD, what="out")
    close(s, js, **FWD, what="sum")
    close(sq, jsq, **FWD, what="sumsq")
    close(xt.grad, jcb.from_planes(jdxp, H, W, geo), **GRAD, what="dx")
    close(kt.grad, jdk, **GRAD, what="dW")


def test_conv3x3_skip_matches_xla_concat_conv():
    """K1 with a skip input == one XLA conv over cat([skip, x])."""
    rng = np.random.default_rng(1)
    B, H, W, cx, cs, cout = 2, 6, 10, 4, 8, 16
    x = rng.standard_normal((B, H, W, cx)).astype(np.float32)
    skip = rng.standard_normal((B, H, W, cs)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cs + cx, cout)) * 0.2).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.concatenate([skip, x], -1), k, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    kt = t(k)
    out, s, sq = cb.conv3x3_stats(t(x), kt[:, :, cs:], t(skip), kt[:, :, :cs])
    close(out, ref, **FWD)
    close(s, np.asarray(ref).sum((1, 2)), **FWD)
    close(sq, (np.asarray(ref) ** 2).sum((1, 2)), **FWD)


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("with_skip", [False, True])
def test_convblock_stage_matches_jax(monkeypatch, pallas, with_skip):
    """The port's kernel-path ConvBlock (conv -> stats -> BN -> ReLU, twice)
    == JAX ConvBlock through the Pallas stage (interpret mode) and through
    XLA: output, updated running statistics, gradients of params, x, skip."""
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", pallas)
    rng = np.random.default_rng(2)
    B, H, W, cx, cs, f = 2, 8, 12, 8, 8, 16
    x = rng.standard_normal((B, H, W, cx)).astype(np.float32)
    skip = rng.standard_normal((B, H, W, cs)).astype(np.float32) if with_skip else None
    tgt = rng.standard_normal((B, H, W, f)).astype(np.float32)
    jb = JConvBlock(features=f, momentum=0.1, dtype=jnp.float32)
    kw = {} if skip is None else {"skip": jnp.asarray(skip)}
    v = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True, **kw)

    def jloss(params, xx, ss):
        kk = {} if ss is None else {"skip": ss}
        y, mut = jb.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          train=True, mutable=["batch_stats"], **kk)
        return jnp.mean((y - tgt) ** 2), (y, mut["batch_stats"])

    args = (v["params"], jnp.asarray(x), None if skip is None else jnp.asarray(skip))
    (_, (jy, jstats)), jg = jax.value_and_grad(
        jloss, (0, 1) if skip is None else (0, 1, 2), has_aux=True)(*args)

    blk = ConvBlock(cx + (cs if with_skip else 0), f, 0.1, torch.float32)
    c0, bn0, _, c1, bn1, _ = blk.conv
    load_block(blk, v["params"], v["batch_stats"], {"conv0": c0, "conv1": c1},
               {"bn0": bn0, "bn1": bn1})
    xt = t(x).requires_grad_()
    st = t(skip).requires_grad_() if with_skip else None
    y = blk(xt, skip=st, train=True)
    ((y - t(tgt)) ** 2).mean().backward()

    close(y, jy, **FWD, what="out")
    for name, bn in (("bn0", bn0), ("bn1", bn1)):
        close(bn.running_mean, jstats[name]["mean"], **FWD, what=f"{name} mean")
        close(bn.running_var, jstats[name]["var"], **FWD, what=f"{name} var")
        close(bn.weight.grad, jg[0][name]["scale"], **GRAD, what=f"{name} dscale")
        close(bn.bias.grad, jg[0][name]["bias"], **GRAD, what=f"{name} dbias")
    close(hwio(c0.weight.grad), jg[0]["conv0"]["kernel"], **GRAD, what="dk0")
    close(hwio(c1.weight.grad), jg[0]["conv1"]["kernel"], **GRAD, what="dk1")
    close(xt.grad, jg[1], **GRAD, what="dx")
    if with_skip:
        close(st.grad, jg[2], **GRAD, what="dskip")


def _upconv_jax_grads(fn, x, k3, gy, gs, gq):
    """(out NHWC, sum, sumsq, dx, dk3) of a JAX upconv formulation ``fn(x, k3)
    -> (out NHWC, sum, sumsq)`` under the loss sum(out*gy + s*gs + sq*gq)."""
    def loss(xx, kk):
        out, s, sq = fn(xx, kk)
        return (jnp.sum(out * gy) + jnp.sum(s * gs) + jnp.sum(sq * gq)), (out, s, sq)

    (_, aux), (dx, dk) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(k3))
    return (*aux, dx, dk)


def _upconv_plane(x, k3):
    B, H, W, cin = x.shape
    cout = k3.shape[-1]
    gi = jcb.pick_geometry(H, W, max(cin, cout), 4)
    go = jcb.pick_geometry(2 * H, 2 * W, cout, 4)
    out, s, sq = jcb.upconv_plane(jcb.to_planes(x, jnp.float32, gi), k3, H, W, gi, go)
    return jcb.from_planes(out, 2 * H, 2 * W, go), s, sq


def _upconv_plane_parity(x, k3):
    B, H, W, cin = x.shape
    geo = jcb.pick_geometry(H, W, max(cin, k3.shape[-1]), 4)
    out, s, sq = jcb.upconv_plane_parity(jcb.to_planes(x, jnp.float32, geo), k3, H, W, geo)
    q = [jcb.from_planes(out[:, p], H, W, geo) for p in range(4)]
    z0 = jnp.stack([q[0], q[1]], 3).reshape(B, H, 2 * W, -1)
    z1 = jnp.stack([q[2], q[3]], 3).reshape(B, H, 2 * W, -1)
    return jnp.stack([z0, z1], 2).reshape(B, 2 * H, 2 * W, -1), s, sq


def _upconv_xla(x, k3):
    out = conv3x3_on_upsampled(x, k3)
    return out, out.sum((1, 2)), (out * out).sum((1, 2))


@pytest.mark.parametrize("formulation", ["plane", "parity", "xla"])
def test_upconv_matches_jax(monkeypatch, formulation):
    """K2 (forward + stats) and K3 (dx) plain versions, with the torch tap
    fold carrying dW, == JAX upconv_plane / upconv_plane_parity (Pallas,
    interpret mode) and the XLA transposed-conv formulation."""
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "1")
    fn = {"plane": _upconv_plane, "parity": _upconv_plane_parity,
          "xla": _upconv_xla}[formulation]
    rng = np.random.default_rng(3)
    B, H, W, cin, cout = 2, 6, 8, 16, 8
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    k3 = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    gy = rng.standard_normal((B, 2 * H, 2 * W, cout)).astype(np.float32)
    gs = rng.standard_normal((B, cout)).astype(np.float32)
    gq = rng.standard_normal((B, cout)).astype(np.float32) * 0.01
    jout, js, jsq, jdx, jdk = _upconv_jax_grads(fn, x, k3, gy, gs, gq)

    xt = t(x).requires_grad_()
    kt = t(k3).requires_grad_()
    out, s, sq = cb.upconv3x3_bn_stats(xt, kt)
    ((out * t(gy)).sum() + (s * t(gs)).sum() + (sq * t(gq)).sum()).backward()
    close(out, jout, **FWD, what="out")
    close(s, js, **FWD, what="sum")
    close(sq, jsq, **FWD, what="sumsq")
    close(xt.grad, jdx, **GRAD, what="dx")
    close(kt.grad, jdk, **GRAD, what="dk3")


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_upconv_module_matches_jax(monkeypatch, pallas):
    """Port UpConv (K2 path) == JAX UpConv (plane path / XLA path): output,
    running statistics, gradients."""
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", pallas)
    monkeypatch.setenv("CONTRASTYOU_PLANE_UPCONV", "1")
    rng = np.random.default_rng(4)
    B, H, W, cin, f = 2, 6, 8, 16, 8
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    tgt = rng.standard_normal((B, 2 * H, 2 * W, f)).astype(np.float32)
    ju = JUpConv(features=f, momentum=0.1, dtype=jnp.float32)
    v = ju.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    geo = jcb.pick_geometry(2 * H, 2 * W, f, 4) if pallas == "1" else None

    def jloss(params, xx):
        y, mut = ju.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          train=True, mutable=["batch_stats"], plane_out_geo=geo)
        if geo is not None:
            y = jcb.from_planes(y, 2 * H, 2 * W, geo)
        return jnp.mean((y - tgt) ** 2), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    up = UpConv(cin, f, 0.1, torch.float32)
    _, conv, bn, _ = up.up
    load_block(up, v["params"], v["batch_stats"], {"conv": conv}, {"bn": bn})
    xt = t(x).requires_grad_()
    y = up(xt, train=True)
    ((y - t(tgt)) ** 2).mean().backward()
    close(y, jy, **FWD, what="out")
    close(bn.running_mean, jstats["bn"]["mean"], **FWD)
    close(bn.running_var, jstats["bn"]["var"], **FWD)
    close(hwio(conv.weight.grad), jgp["conv"]["kernel"], **GRAD, what="dk")
    close(bn.weight.grad, jgp["bn"]["scale"], **GRAD)
    close(xt.grad, jgx, **GRAD, what="dx")


def test_parity_taps_fold_matches_jax():
    rng = np.random.default_rng(5)
    k3 = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    got = cb.parity_taps(t(k3))
    for p in range(4):
        taps, offs = jcb._parity_taps(jnp.asarray(k3), p // 2, p % 2, 100)
        close(got[p], taps, rtol=0, atol=0)
        assert offs == tuple(dy * 100 + dx for dy, dx in
                             (cb._parity_offsets(p, tt) for tt in range(4)))
