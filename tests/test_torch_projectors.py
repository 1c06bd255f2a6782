"""The port's projection heads, cluster heads and pooling
(contrastyou_tpu_torch/models/projectors.py, pooling.py) held against the
flax modules of the JAX package, with the weights carried over by
``utils/torch_convert.py``.

Tolerances. f32: rtol 1e-5 for outputs and gradients, plus an atol of 1e-5
times the tensor's largest value (the same matrix products and means summed
in another order; a weight gradient sums ~1000 products, whose cancellation
leaves its small entries with the error of the large ones). bf16 (the dense head
as it runs on an accelerator: bf16 1x1 convs, pool before the output conv;
JAX with ``CONTRASTYOU_PROJ_BF16=1``): both sides round the same products to
bf16 (8 bits of mantissa), but at other points (torch rounds the leaky ReLU's
product in f32, flax multiplies by the bf16 slope), so single roundings may
flip; the unit-norm outputs (largest component ~0.4) are held to 5e-3
absolute, about one bf16 ulp of it (measured 1.2e-3), and 2e-3 in L2
(measured 4.3e-4); either is within 1e-2 of the f32 head (measured 1.7e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.models.pooling import adaptive_avg_pool2d as javg
from contrastyou_tpu.models.pooling import adaptive_max_pool2d as jmax
from contrastyou_tpu.models.projectors import DenseProjectionHead as JDense
from contrastyou_tpu.models.projectors import ProjectionHead as JHead
from contrastyou_tpu_torch.models.pooling import adaptive_avg_pool2d, adaptive_max_pool2d
from contrastyou_tpu_torch.models.projectors import (DenseProjectionHead, ProjectionHead,
                                                     l2_normalize)
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        head_state_dict_to_flax)
from torch_parity import close, n, t

torch.set_num_threads(1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref, what):
    close(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(ref)).max()), what=what)


def _compare_head(jmod, port, x):
    """Output and the gradients of a fixed projection of it, in the input
    and every parameter."""
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port.load_state_dict(flax_to_head_state_dict(params))
    proj = _x(jmod.apply({"params": params}, jnp.asarray(x)).shape, seed=9)

    def jloss(p, x_):
        return (jmod.apply({"params": p}, x_) * proj).sum()

    jout = jmod.apply({"params": params}, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_()
    out = port(xt)
    (out * t(proj)).sum().backward()
    _close(out, jout, "output")
    _close(xt.grad, jgx, "d input")
    grads = head_state_dict_to_flax({k: p.grad for k, p in port.named_parameters()})
    for layer, leaves in grads.items():
        for k, v in leaves.items():
            _close(v, jgp[layer][k], f"d {layer}/{k}")


def test_projection_head_matches_flax():
    """Encoder head: global pool, Dense 32->24, leaky, Dense 24->16, normalize."""
    x = _x((6, 5, 5, 32))
    _compare_head(JHead(output_dim=16, hidden_dim=24), ProjectionHead(32, 16, 24), x)


def test_dense_projection_head_matches_flax():
    """Decoder head in f32: 1x1 conv 16->24, leaky, 1x1 conv 24->20, pool to
    8x8, normalize over channels."""
    x = _x((4, 16, 16, 16))
    _compare_head(JDense(output_dim=20, hidden_dim=24, spatial_size=(8, 8)),
                  DenseProjectionHead(16, 20, 24, spatial_size=(8, 8)), x)


def test_dense_head_bf16_matches_jax_accelerator_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PROJ_BF16", "1")
    monkeypatch.setenv("CONTRASTYOU_POOL_EARLY", "")
    x = _x((4, 28, 28, 32))
    jmod = JDense(output_dim=64, hidden_dim=64, spatial_size=(4, 4))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))["params"]
    jout = jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    port = DenseProjectionHead(32, 64, 64, spatial_size=(4, 4), bf16=True)
    port.load_state_dict(flax_to_head_state_dict(params))
    out = port(t(x).to(torch.bfloat16))
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    g, r = n(out), np.asarray(jout)
    assert np.abs(g - r).max() <= 5e-3
    assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 2e-3
    # the f32 head on the same weights is the reference both approximate
    ref = DenseProjectionHead(32, 64, 64, spatial_size=(4, 4))
    ref.load_state_dict(port.state_dict())
    assert np.abs(g - n(ref(t(x)))).max() <= 1e-2


@pytest.mark.parametrize("hw,out_hw", [((12, 12), (4, 4)), ((10, 7), (3, 2))])
def test_pooling_matches_jax(hw, out_hw):
    """Divisible grids take the reshape path, others torch-style bins; bf16
    input accumulates in f32."""
    x = _x((2, *hw, 3))
    close(adaptive_avg_pool2d(t(x), out_hw), javg(jnp.asarray(x), out_hw),
          rtol=1e-6, atol=1e-6)
    close(adaptive_max_pool2d(t(x), out_hw), jmax(jnp.asarray(x), out_hw),
          rtol=0, atol=0)
    xb = t(x).to(torch.bfloat16)
    got = adaptive_avg_pool2d(xb, out_hw, accum_dtype=torch.float32)
    ref = javg(jnp.asarray(n(xb), jnp.bfloat16), out_hw, accum_dtype=jnp.float32)
    assert got.dtype == torch.float32
    close(got, ref, rtol=1e-6, atol=1e-6)


def test_l2_normalize_has_a_finite_gradient_at_zero():
    x = torch.zeros(2, 4, requires_grad=True)
    l2_normalize(x).sum().backward()
    assert torch.isfinite(x.grad).all()
    v = torch.tensor([[3.0, 4.0]])
    close(l2_normalize(v), [[0.6, 0.8]], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dense", [False, True], ids=["ClusterHead", "DenseClusterHead"])
def test_cluster_heads_match_flax_through_the_bridge(dense):
    """The udaiic heads (5 subheads, 20 clusters, linear) on random flax
    weights, T = 0.5: outputs [S, B, (H, W,) K] and the gradients of a fixed
    projection in the input and the stacked parameters; the bridge
    round-trips the flax tree."""
    from contrastyou_tpu.models.projectors import ClusterHead as JCluster
    from contrastyou_tpu.models.projectors import DenseClusterHead as JDenseCluster
    from contrastyou_tpu_torch.models.projectors import ClusterHead, DenseClusterHead
    from contrastyou_tpu_torch.utils.torch_convert import (cluster_head_state_dict_to_flax,
                                                            flax_to_cluster_head_state_dict)
    x = _x((3, 6, 5, 24))
    kw = dict(num_clusters=20, num_subheads=5, T=0.5)
    jmod = (JDenseCluster if dense else JCluster)(head_type="linear", **kw)
    port = (DenseClusterHead if dense else ClusterHead)(24, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    sd = flax_to_cluster_head_state_dict(params)
    port.load_state_dict(sd)
    back = cluster_head_state_dict_to_flax(port.state_dict(), dense=dense)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))
    jout = jmod.apply({"params": params}, jnp.asarray(x))
    proj = _x(jout.shape, seed=9)
    jgp, jgx = jax.grad(lambda p, x_: (jmod.apply({"params": p}, x_) * proj).sum(),
                        argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_()
    out = port(xt)
    (out * t(proj)).sum().backward()
    _close(out, jout, "output")
    _close(xt.grad, jgx, "d input")
    grads = cluster_head_state_dict_to_flax({k: p.grad for k, p in port.named_parameters()},
                                            dense=dense)
    for (path, g), r in zip(jax.tree_util.tree_flatten_with_path(grads)[0],
                            jax.tree.leaves(jgp)):
        _close(g, r, f"d {jax.tree_util.keystr(path)}")
    if dense:
        w, b = port.merged_params()
        merged = torch.softmax(((xt @ w + b) / 0.5).reshape(3, 6, 5, 5, 20), -1)
        _close(merged.permute(3, 0, 1, 2, 4), jout, "merged projection")
