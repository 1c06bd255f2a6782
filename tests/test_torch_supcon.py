"""The port's SupCon kernels' plain versions and loss
(contrastyou_tpu_torch/ops/supcon.py, losses/contrastive.py) held against the
JAX package: the Pallas kernels ``fused_sup_con_loss`` in interpret mode and
the eager ``sup_con_loss``, on the same normalized projections.

Shapes are the pretrain paths': M = 2N = 36 anchors with partition labels
(ACDC's encoder hook on 18 slices), M = 180 with identity labels (its decoder
hook, 5 points per slice), and prostate's M = 96 (8 partitions of 48 slices)
and M = 480 (its decoder hook), d = 256, f32. Tolerances are those of the JAX
package's own fused-vs-eager test (tests/test_pallas.py): loss rtol 1e-5 (the
same f32 sums in another order), dz atol 1e-6 (|dz| <= ~1e-2 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.losses.contrastive import _expand_masks as jexpand
from contrastyou_tpu.losses.contrastive import pair_masks_from_target as jmasks
from contrastyou_tpu.losses.contrastive import sup_con_loss as jsup_con
from contrastyou_tpu.ops.pallas import fused_sup_con_loss as jfused
from contrastyou_tpu_torch.losses.contrastive import (FUSED_MAX_ANCHORS, fused_route,
                                                      pair_masks_from_target,
                                                      sup_con_loss)
from contrastyou_tpu_torch.ops import supcon
from torch_parity import close, n, t

torch.set_num_threads(1)

T = 0.07
# (label name, N per view, labels): partition labels of 6 scans x 3
# partitions (ACDC's encoder hook), identity labels (ACDC's decoder hook, 18
# slices x 5 points); prostate's: 6 scans x 8 partitions of 48 slices, and
# its decoder hook's 48 x 5 points
CASES = [("partition", 18, np.tile(np.arange(3), 6)), ("self", 90, None),
         ("prostate-partition", 48, np.tile(np.arange(8), 6)),
         ("prostate-self", 240, None)]


def _features(n_, d=256, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, n_, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return f[0], f[1]


def _jax_masks(labels, n_):
    pos, neg = jmasks(None if labels is None else jnp.asarray(labels), n_)
    return jexpand(pos, neg, n_)


@pytest.mark.parametrize("name,n_,labels", CASES, ids=[c[0] for c in CASES])
def test_plain_kernels_match_the_pallas_kernels(name, n_, labels):
    f1, f2 = _features(n_)
    z = np.concatenate([f1, f2])
    pos, neg = _jax_masks(labels, n_)
    jloss, jdz = jax.value_and_grad(lambda z_: jfused(z_, pos, neg, T))(jnp.asarray(z))
    code = supcon.pair_code(t(pos), t(neg))
    loss, lse, pcount = supcon.supcon_loss(t(z), code, T)      # CPU: the plain version
    assert loss.shape == lse.shape == pcount.shape == (2 * n_,)
    close(loss.mean(), jloss, rtol=1e-5, atol=0, what="D1 loss")
    dz = supcon.supcon_dz(t(z), code, lse, pcount, torch.ones(()), T)
    close(dz, jdz, rtol=0, atol=1e-6, what="D2 dz")
    # the residuals D2's kernel reads: the positive count and the log of the
    # softmax denominator
    np.testing.assert_array_equal(n(pcount), np.asarray(pos).sum(1))
    s = z @ z.T / T
    m = np.asarray(pos + neg) > 0
    ref_lse = np.log(np.where(m, np.exp(s - s.max(1, keepdims=True)), 0).sum(1)) + s.max(1)
    close(lse, ref_lse, rtol=1e-5, atol=1e-5, what="lse")


@pytest.mark.parametrize("name,n_,labels", CASES, ids=[c[0] for c in CASES])
def test_losses_match_jax_eager(name, n_, labels):
    """The port's fused function (D1 forward, D2 backward through autograd)
    and its eager form, each against JAX's eager ``sup_con_loss``."""
    f1, f2 = _features(n_, seed=1)
    target = None if labels is None else jnp.asarray(labels)
    jl, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jsup_con(a, b, target=target, temperature=T, fused=False),
        argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    tt = None if labels is None else torch.tensor(labels)
    for fused in (True, False):
        a, b = t(f1).requires_grad_(), t(f2).requires_grad_()
        loss = sup_con_loss(a, b, target=tt, temperature=T, fused=fused)
        loss.backward()
        close(loss, jl, rtol=1e-5, atol=0, what=f"loss fused={fused}")
        close(a.grad, jg1, rtol=0, atol=1e-6, what=f"grad view 1 fused={fused}")
        close(b.grad, jg2, rtol=0, atol=1e-6, what=f"grad view 2 fused={fused}")


def test_eager_variants_match_jax():
    """``exclude_other_pos`` and an explicit ``mask`` (with an ignored pair
    value 2) take the eager form in both packages."""
    f1, f2 = _features(6, d=16, seed=2)
    mask = np.random.default_rng(3).integers(0, 3, (6, 6))
    for kw in ({"exclude_other_pos": True, "target": np.array([0, 1, 0, 2, 1, 0])},
               {"mask": mask}):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jl = jsup_con(jnp.asarray(f1), jnp.asarray(f2), temperature=T, **jkw)
        close(sup_con_loss(t(f1), t(f2), temperature=T, **tkw), jl, rtol=1e-5, atol=0,
              what=str(list(kw)))
    loss, aux = sup_con_loss(t(f1), t(f2), temperature=T, return_aux=True)
    assert aux["pos_mask"].shape == (12, 12) and float(aux["pos_mask"].trace()) == 0


def test_gate_routes_like_jax():
    """The gate has JAX's shape: CUDA tensors with neither option take the
    kernels at JAX's fused counts (2N <= 256); the CPU and the options take
    the eager form. Its number is the card's (below)."""
    assert fused_route(36, "cuda") and fused_route(180, "cuda:0") and fused_route(256, "cuda")
    assert not fused_route(36, "cpu")
    assert not fused_route(36, "cuda", return_aux=True)
    assert not fused_route(36, "cuda", exclude_other_pos=True)


def test_gate_routes_as_the_card_measured():
    """CUDA tensors with neither option take the kernels at every 2N up to
    their capacity: on the H100 the fused form was no slower than the eager
    one, in wall and in device time, at every measured 2N from 36 to 4096
    (chip_smoke.py phase 4b), the prostate dense hook's 480 among them. The
    CPU, larger batches and the options take the eager form."""
    assert FUSED_MAX_ANCHORS == supcon.MAX_ANCHORS == 46340
    for anchors in (36, 96, 180, 256, 480, 960, 2048, 4096, 46340):
        assert fused_route(anchors, "cuda") and fused_route(anchors, "cuda:0")
    assert not fused_route(46342, "cuda")
    assert not fused_route(36, "cpu")
    assert not fused_route(36, "cuda", return_aux=True)
    assert not fused_route(36, "cuda", exclude_other_pos=True)


def test_pair_code_and_masks():
    pos, neg = pair_masks_from_target(torch.tensor([0, 1, 0]), 3)
    np.testing.assert_array_equal(n(pos), np.asarray(jmasks(jnp.asarray([0, 1, 0]), 3)[0]))
    code = supcon.pair_code(pos, neg)
    assert code.dtype == torch.uint8
    np.testing.assert_array_equal(code.numpy(), (n(pos) + 2 * n(neg)).astype(np.uint8))


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The checks that guard the launches raise before any library is
    needed: a CPU tensor, the wrong dtype, a mask of the wrong shape."""
    z = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        supcon._cuda_check("k", z, torch.zeros(4, 4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        supcon._cuda_check("k", z.double(), torch.zeros(4, 4, dtype=torch.uint8))
