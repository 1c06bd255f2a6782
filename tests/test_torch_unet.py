"""The port's U-Net (contrastyou_tpu_torch/models/unet.py) held against the
JAX U-Net on the XLA path (CONTRASTYOU_PALLAS_CONV=0), with the same weights
through the parameter bridge (contrastyou_tpu_torch/utils/torch_convert.py).

Tolerances. f32: max |port - jax| <= 1e-3 of the largest value for values
(the same convolutions and BatchNorms summed in another order, through 23
layers with train-mode BN on a batch of 2) and 1e-2 for gradients (the BN
backward subtracts terms ~100x larger than its result; measured worst
3.8e-3, the Up2 BN bias). bf16 cannot be compared element for element:
a bf16 evaluation of this network moves its logits and gradients by 10-20%
from f32, and a second bf16 evaluation (JAX rounds at other places) lands as
far again; the gradients of the bf16 network are 40-90% away from f32 (in
L2, per tensor) in both frameworks. So the bf16 port is held to being as
accurate as the bf16 JAX model. Values (logits, taps, running statistics):
max distance to the f32 JAX result at most twice JAX bf16's, plus 1% of the
largest value (measured worst ratio 1.2). Gradients: L2 distance at most 1.5
times JAX bf16's plus 0.05, per conv kernel (measured worst ratio 1.25) and
over all parameters together; the BN scale / bias gradients alone are sums of
~2000 sign-mixed products that bf16 leaves at 60-110% noise in both
frameworks, so they count only in the whole-gradient bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.models.unet import UNet as JUNet
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_state_dict,
                                                        state_dict_to_flax)
from torch_parity import n, scaled_close, t

torch.set_num_threads(1)

B, S = 2, 32
TAPS = ("Conv3", "Up_conv2")


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")


def _data():
    return np.random.default_rng(0).random((B, S, S, 1)).astype(np.float32), _proj


def _proj(shape):
    """Fixed random projection the loss contracts the output with."""
    return np.random.default_rng(1).standard_normal(shape).astype(np.float32)


def _variables(x):
    jm = JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"])


def _jax_run(dtype, params, stats, x, proj, until=None):
    jm = JUNet(max_channel=128, momentum=0.1, dtype=dtype)

    def loss(p):
        (y, taps), mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                  until=until, taps=TAPS if until is None else (),
                                  train=True, mutable=["batch_stats"])
        return jnp.mean(y * proj(y.shape)), (y, taps, mut["batch_stats"])

    (_, (y, taps, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    eval_y, _ = jax.jit(lambda p: jm.apply({"params": p, "batch_stats": stats},
                                           jnp.asarray(x), train=False))(params)
    return dict(y=y, taps=taps, stats=new_stats, grads=grads, eval_y=eval_y)


def _port_run(dtype, params, stats, x, proj, until=None):
    m = UNet(max_channel=128, momentum=0.1, dtype=dtype)
    m.load_state_dict(flax_to_state_dict(params, stats))
    eval_y, _ = m(t(x), train=False)
    y, taps = m(t(x), until=until, taps=TAPS if until is None else (), train=True)
    (y * t(proj(tuple(y.shape)))).mean().backward()
    sd = {k: v for k, v in m.state_dict().items()}
    grads = state_dict_to_flax({**{k: torch.zeros_like(v) for k, v in sd.items()},
                                **{k: p.grad for k, p in m.named_parameters() if p.grad is not None}})["params"]
    return dict(y=y, taps=taps, stats=state_dict_to_flax(sd)["batch_stats"],
                grads=grads, eval_y=eval_y)


@pytest.fixture(scope="module")
def setup():
    """(x, projection, params, stats, leaves of the f32 JAX run)."""
    x, proj = _data()
    params, stats = _variables(x)
    return x, proj, params, stats, _leaves(_jax_run(jnp.float32, params, stats, x, proj))


def _tol(name: str) -> float:
    return 1e-2 if name.startswith("grads") else 1e-3


def _leaves(res):
    """(name, array) pairs of everything a run returns."""
    out = [("logits", res["y"]), ("eval logits", res["eval_y"])]
    out += [(f"tap {k}", res["taps"][k]) for k in sorted(res["taps"])]
    for coll in ("stats", "grads"):
        flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(n, res[coll]))[0]
        out += [(f"{coll} {jax.tree_util.keystr(p)}", v) for p, v in flat]
    return out


def test_unet_f32_matches_jax(setup):
    """Logits (train and eval mode), taps, updated running statistics and
    every parameter gradient."""
    x, proj, params, stats, ref = setup
    got = _leaves(_port_run(torch.float32, params, stats, x, proj))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (name, g), (_, r) in zip(got, ref):
        scaled_close(g, r, tol=_tol(name), what=name)


@pytest.mark.parametrize("until", ["Conv2", "Conv4", "Up_conv3"])
def test_unet_until_matches_jax(setup, until):
    x, proj, params, stats, _ = setup
    ref = _jax_run(jnp.float32, params, stats, x, proj, until=until)
    got = _port_run(torch.float32, params, stats, x, proj, until=until)
    assert tuple(got["y"].shape) == tuple(ref["y"].shape)
    scaled_close(got["y"], ref["y"], tol=1e-3, what=until)
    for (name, g), (_, r) in zip(_leaves(got), _leaves(ref)):
        if name.startswith("grads"):
            scaled_close(g, r, tol=_tol(name), what=name)


def _l2(a, r):
    return np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30)


def test_unet_bf16_as_accurate_as_jax(setup):
    x, proj, params, stats, ref = setup
    jax16 = _leaves(_jax_run(jnp.bfloat16, params, stats, x, proj))
    port16 = _leaves(_port_run(torch.bfloat16, params, stats, x, proj))
    grads = ([], [], [])
    for (name, r), (_, j), (_, p) in zip(ref, jax16, port16):
        r, j, p = n(r), n(j), n(p)
        if name.startswith("grads"):
            for acc, v in zip(grads, (r, j, p)):
                acc.append(v.ravel())
            if "kernel" not in name:
                continue            # BN scale / bias grads: see the docstring
            e_jax, e_port = _l2(j, r), _l2(p, r)
            bound = 1.5 * e_jax + 5e-2
        else:
            scale = max(np.abs(r).max(), 1e-30)
            e_jax, e_port = np.abs(j - r).max() / scale, np.abs(p - r).max() / scale
            bound = 2 * e_jax + 1e-2
        assert e_port <= bound, f"{name}: port {e_port:.3e} vs jax {e_jax:.3e}"
    r, j, p = (np.concatenate(v) for v in grads)
    assert _l2(p, r) <= 1.5 * _l2(j, r) + 5e-2, (_l2(p, r), _l2(j, r))


def test_bridge_round_trip(setup):
    _, _, params, stats, _ = setup
    m = UNet(max_channel=128)
    m.load_state_dict(flax_to_state_dict(params, stats))
    back = state_dict_to_flax(m.state_dict())
    for a, b in ((back["params"], params), (back["batch_stats"], stats)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(la, lb)
