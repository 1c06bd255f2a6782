"""The port's other architectures (contrastyou_tpu_torch/models/{resunet,
unet2}.py, the GroupNorm U-Net of models/unet.py) and the net-driven
parameter bridge (utils/torch_convert.py ``key_map``) held against the JAX
package on the same weights, on the CPU (the kernels' plain versions).

Tolerances. f32 values (logits, every named tap, updated running
statistics): relative L2 distance <= 1e-4 (the same convolutions and norms
summed in another order; measured <= 3e-5). f32 gradients, against JAX in
f64: relative L2 <= 1e-4 per tensor (measured <= 8.2e-6 for the nets alone,
6.8e-5 through the ResUNet's semi step with the consistency hook, whose
update is the gradient under sgd at lr 1; its losses at rtol 1e-5 and
running statistics at 1e-5); jitted JAX f32 is the noisier side, since a
norm bias's gradient sums ~2000 sign-mixed terms whose order XLA changes.
bf16 (ResUNet): as accurate as JAX bf16 against JAX f32, at most twice JAX
bf16's distance plus 1% of the largest value (the convention of
tests/test_torch_unet.py). The per-sample statistics cotangent through the
K1 / K2 Functions: 1e-5 of the largest value against autograd of the plain
convs (the same f32 sums). The bridge and the warm start: exact.
"""
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contrastyou_tpu.models import get_arch as jget_arch
from contrastyou_tpu.models import resunet as jax_resunet
from contrastyou_tpu.models import unet as jax_unet
from contrastyou_tpu.utils.torch_convert import load_npz_tree as jload_npz
from contrastyou_tpu.utils.torch_convert import merge_pretrained as jmerge
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.checkpoint import (extract_model_params, save_checkpoint,
                                                     train_state_dict)
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import build_train_step, init_train_state
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.mt import EMAEvalTrainerHook
from contrastyou_tpu_torch.models import get_arch, resunet
from contrastyou_tpu_torch.models.unet import GroupNorm
from contrastyou_tpu_torch.ops.convblock import conv3x3_bn_stats, upconv3x3_bn_stats
from contrastyou_tpu_torch.utils.torch_convert import (convert_resnet_encoder,
                                                        flax_to_hook_state,
                                                        flax_to_state_dict, hook_state_to_flax,
                                                        key_map, load_pretrained, save_npz_tree,
                                                        state_dict_to_flax)
from test_torch_optim_knobs import jax_semi_step_f64
from test_torch_step import _replayed_draws
from torch_parity import n, scaled_close, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 32
#: each net: (get_arch name, its keyword arguments at the test's width)
NETS = {"unet": ("unet", dict(max_channel=128)),
        "unet_gn": ("unet", dict(max_channel=128, norm="groupnorm")),
        "resunet": ("resunet", dict(max_channel=64)),
        "unet2": ("unet2", dict(dim=8)),
        "unet2_time": ("unet2", dict(dim=8, with_time_emb=True))}
TIME = np.array([3.0, 250.0], np.float32)
NAMED = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5", "Up_conv5", "Up_conv4", "Up_conv3",
         "Up_conv2", "Deconv_1x1")


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _x(seed=0, b=B):
    return np.random.default_rng(seed).random((b, S, S, 1)).astype(np.float32)


def _rel(a, b):
    a, b = n(a), n(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_net(key, dtype=jnp.float32):
    name, kw = NETS[key]
    return jget_arch(name, input_dim=1, num_classes=4, **kw,
                     **({} if name == "unet2" else {"dtype": dtype}))


def _port_net(key, dtype=torch.float32):
    name, kw = NETS[key]
    return get_arch(name, input_dim=1, num_classes=4, **kw,
                    **({} if name == "unet2" else {"dtype": dtype}))


@pytest.fixture(scope="module")
def variables():
    """Each net's flax variables: the tree and shapes of its ``init``
    (traced, not run), filled from a seeded generator: kernels LeCun-normal,
    norm scales and biases moved off 1 and 0, running statistics away from 0
    and 1; numpy trees."""
    out = {}
    rng = np.random.default_rng(1)
    for key in NETS:
        kw = {"time": jnp.asarray(TIME)} if key == "unet2_time" else {}
        shapes = jax.eval_shape(lambda: _jax_net(key).init(jax.random.PRNGKey(0),
                                                           jnp.asarray(_x()), **kw))

        def fill(path, a):
            name = jax.tree_util.keystr(path)
            if name.endswith("['var']"):
                return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
            if name.endswith("['kernel']"):
                fan_in = int(np.prod(a.shape[:-1]))
                return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
            base = 1.0 if name.endswith("['scale']") else 0.0
            return (base + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)

        out[key] = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    return out


def _apply(key, v, x, dtype=jnp.float32, **kw):
    """The JAX net's train-mode forward, jitted (one compile instead of one
    per op) -> ((out, taps), updated variables)."""
    jm = _jax_net(key, dtype)
    train = kw.pop("train", True)
    fn = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=["batch_stats"], **kw))
    return fn(v, jnp.asarray(x))


def _loaded(key, variables, dtype=torch.float32):
    m = _port_net(key, dtype)
    v = variables[key]
    m.load_state_dict(flax_to_state_dict(v["params"], v.get("batch_stats", {}), m))
    return m


# --- forward and gradient against JAX --------------------------------------

@pytest.mark.parametrize("key", ["resunet", "unet_gn"])
def test_forward_matches_jax(key, variables):
    """Train mode: logits, every named layer's tap, the updated running
    statistics (ResUNet; the GroupNorm net has none); eval mode: logits."""
    v, x = variables[key], _x()
    (jout, jtaps), upd = _apply(key, v, x, taps=NAMED)
    m = _loaded(key, variables)
    out, taps = m(t(x), taps=NAMED, train=True)
    assert _rel(out, jout) <= 1e-4
    for name in NAMED:
        assert _rel(taps[name], jtaps[name]) <= 1e-4, name
    stats = state_dict_to_flax(m.state_dict(), m)["batch_stats"]
    if key == "unet_gn":
        assert stats == {} and not list(m.buffers())
    for path, a in jax.tree_util.tree_flatten_with_path(stats)[0]:
        b = upd["batch_stats"]
        for k in path:
            b = b[k.key]
        assert _rel(a, b) <= 1e-4, jax.tree_util.keystr(path)
    (jeval, _), _ = _apply(key, v, x, train=False)
    assert _rel(_loaded(key, variables)(t(x), train=False)[0], jeval) <= 1e-4


@pytest.mark.parametrize("key", ["resunet", "unet_gn"])
def test_gradient_matches_jax(key, variables):
    """d/dparams of sum(logits * P) in train mode, against JAX in f64 (x64
    on, jitted, the f32 casts of JAX's nets promoted to f64)."""
    v, x = variables[key], _x()
    proj = np.random.default_rng(2).standard_normal((B, S, S, 4))
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in (jax_unet, jax_resunet):
            mp.setattr(module, "jnp", promoted)
        jm = _jax_net(key, jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)

        def loss(params):
            (out, _), _ = jm.apply({"params": params, "batch_stats": v64.get("batch_stats", {})},
                                   jnp.asarray(x, jnp.float64), train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(out * proj)

        jgrad = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v64["params"]))
    m = _loaded(key, variables)
    (m(t(x), train=True)[0] * t(proj)).sum().backward()
    grads = state_dict_to_flax({k: p.grad for k, p in m.named_parameters()}
                               | dict(m.named_buffers()), m)["params"]
    errs = {jax.tree_util.keystr(path): _rel(a, b) for (path, a), b in
            zip(jax.tree_util.tree_flatten_with_path(grads)[0], jax.tree.leaves(jgrad))}
    print(f"{key}: worst gradient relative L2 against JAX f64 {max(errs.values()):.3e}")
    for name, err in errs.items():
        assert err <= 1e-4, name


def test_resunet_semi_step_matches_jax(variables):
    """One ``semi`` step with the consistency hook on ResUNet (two-stage BN)
    against JAX's step in f64 on the same draws (sgd at lr 1: the update is
    minus the gradient): losses, gradients, running statistics."""
    nl = nu = 2
    rng = np.random.default_rng(0)
    batch = {"labeled_image": _x(3, nl), "labeled_target": rng.integers(0, 4, (nl, S, S)),
             "unlabeled_image": _x(4, nu)}
    v, key = variables["resunet"], jax.random.PRNGKey(7)
    jparams, jstats, jm = jax_semi_step_f64(_jax_net("resunet", jnp.float64), v["params"],
                                            v["batch_stats"], batch, key, two_stage=True)
    m = _loaded("resunet", variables)
    opt, _ = create_optimizer(m.parameters(), {"name": "sgd", "lr": 1.0}, None, max_epoch=1,
                              steps_per_epoch=1)
    pbundle = ModelBundle(m, (S, S, 1))
    phooks = [ConsistencyTrainerHook(weight=10.0)]
    pstate = init_train_state(pbundle, phooks, opt)
    metrics = build_train_step(pbundle, phooks)(
        pstate, {k: torch.tensor(a) for k, a in batch.items()}, _replayed_draws(key))
    for k in ("sup_loss", "reg_loss", "consistency/loss"):
        np.testing.assert_allclose(n(metrics[k]), jm[k], rtol=1e-5, err_msg=k)
    new = state_dict_to_flax(m.state_dict(), m)
    errs = {jax.tree_util.keystr(path): _rel(a - p, b - p) for (path, a), b, p in
            zip(jax.tree_util.tree_flatten_with_path(new["params"])[0],
                jax.tree.leaves(jparams), jax.tree.leaves(v["params"]))}
    print(f"resunet semi step: worst gradient relative L2 against JAX f64 "
          f"{max(errs.values()):.3e}")
    for name, err in errs.items():
        assert err <= 1e-4, name
    for a, b in zip(jax.tree.leaves(new["batch_stats"]), jax.tree.leaves(jstats)):
        assert _rel(a, b) <= 1e-5


def test_resunet_bf16_as_accurate_as_jax(variables):
    v, x = variables["resunet"], _x()
    ref = _apply("resunet", v, x, taps=NAMED)[0]
    (jout, jtaps), _ = _apply("resunet", v, x, jnp.bfloat16, taps=NAMED)
    out, taps = _loaded("resunet", variables, torch.bfloat16)(t(x), taps=NAMED, train=True)
    for name, got, jgot, want in [("logits", out, jout, ref[0])] + [
            (k, taps[k], jtaps[k], ref[1][k]) for k in NAMED]:
        w = n(want)
        bound = 2 * np.abs(n(jgot) - w).max() + 0.01 * np.abs(w).max()
        assert np.abs(n(got) - w).max() <= bound, name


def test_stride2_same_padding(variables, monkeypatch):
    """flax pads a stride-2 3x3 SAME conv (0, 1) at an even size: the port
    matches JAX with that padding and not with torch's symmetric (1, 1)."""
    assert resunet.same_pad(S, 3, 2) == (0, 1) and resunet.same_pad(S, 1, 2) == (0, 0)
    v, x = variables["resunet"], _x()
    (_, jtaps), _ = _apply("resunet", v, x, taps=("Conv2",))
    m = _loaded("resunet", variables)
    assert _rel(m(t(x), taps=("Conv2",))[1]["Conv2"], jtaps["Conv2"]) <= 1e-4
    same_pad = resunet.same_pad
    monkeypatch.setattr(resunet, "same_pad",
                        lambda size, k, s: (1, 1) if (k, s) == (3, 2) else same_pad(size, k, s))
    m = _loaded("resunet", variables)
    assert _rel(m(t(x), taps=("Conv2",))[1]["Conv2"], jtaps["Conv2"]) > 0.1


@pytest.mark.parametrize("key", ["unet2", "unet2_time"])
def test_unet2_matches_jax(key, variables):
    """UNet2 without and with the time embedding."""
    x, time = _x(), key == "unet2_time"
    jm = _jax_net(key)
    kw = {"time": jnp.asarray(TIME)} if time else {}
    jout = jax.jit(lambda v, x: jm.apply(v, x, **kw)[0])(variables[key], jnp.asarray(x))
    m = _loaded(key, variables)
    out, taps = m(t(x), time=torch.tensor(TIME) if time else None)
    assert taps == {} and _rel(out, jout) <= 1e-4
    with pytest.raises(ValueError, match="until"):
        m(t(x), taps=("Conv1",))


@pytest.mark.parametrize("up", [False, True])
def test_per_sample_stats_cotangent(up):
    """The GroupNorm net's statistics cotangent differs per sample: the K1
    (``conv3x3_bn_stats``, with a skip) and K2 (``upconv3x3_bn_stats``)
    Functions fold a non-uniform [B, C] cotangent of the sums and sums of
    squares as autograd of the plain convs does."""
    rng = np.random.default_rng(5)
    cin, cout, h = 8, 16, 6
    x = t(rng.standard_normal((3, h, h, cin))).requires_grad_()
    w = t(rng.standard_normal((3, 3, cin if up else 2 * cin, cout)) * 0.2).requires_grad_()
    skip = t(rng.standard_normal((3, h, h, cin))).requires_grad_()
    g_out, g_s, g_q = (t(rng.standard_normal(s)) for s in
                       ((3, 2 * h if up else h, 2 * h if up else h, cout), (3, cout), (3, cout)))

    def plain():
        if up:
            a = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
            p = F.conv2d(a, w.permute(3, 2, 0, 1), padding=1)
        else:
            p = F.conv2d(torch.cat([skip, x], -1).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         padding=1)
        p = p.permute(0, 2, 3, 1)
        return p, p.sum((1, 2)), (p * p).sum((1, 2))

    def fn():
        if up:
            return upconv3x3_bn_stats(x, w)
        return conv3x3_bn_stats(x, w[:, :, cin:], skip, w[:, :, :cin])

    grads = []
    for f in (fn, plain):
        p, s, q = f()
        ins = (x, w) if up else (x, w, skip)
        grads.append(torch.autograd.grad((p * g_out).sum() + (s * g_s).sum()
                                         + (q * g_q).sum(), ins))
    for a, b in zip(*grads):
        scaled_close(a, b, tol=1e-5)


# --- the bridge, checkpoints and warm starts ----------------------------------

@pytest.mark.parametrize("key", sorted(NETS))
def test_bridge_round_trip(key, variables, tmp_path):
    """flax -> state_dict -> flax bit for bit; the map covers the model's
    state_dict; a mean-teacher / EMA hook state and a checkpoint's model
    parameters round-trip too."""
    v = variables[key]
    m = _port_net(key)
    sd = flax_to_state_dict(v["params"], v.get("batch_stats", {}), m)
    assert sorted(sd) == sorted(m.state_dict()) == sorted(r[0] for r in key_map(m))
    m.load_state_dict(sd)
    back = state_dict_to_flax(m.state_dict(), m)
    for coll in ("params", "batch_stats"):
        jax.tree.map(np.testing.assert_array_equal, back[coll], v.get(coll, {}))
    state = {"ema_params": v["params"], "ema_batch_stats": v.get("batch_stats", {}),
             "ema_step": np.int32(3)}
    hs = flax_to_hook_state(state, m)
    assert hs["ema_step"] == 3 and sorted(hs["ema_params"]) == sorted(dict(m.named_parameters()))
    jax.tree.map(np.testing.assert_array_equal, hook_state_to_flax(hs, m)["ema_params"],
                 v["params"])
    if key != "unet2":
        hook = EMAEvalTrainerHook(alpha=0.9)
        bundle = ModelBundle(m, (S, S, 1))
        opt, _ = create_optimizer(m.parameters(), {"name": "adam", "lr": 1e-3}, None,
                                  max_epoch=1, steps_per_epoch=1)
        st = init_train_state(bundle, [hook], opt)
        save_checkpoint(tmp_path / "last", train_state=train_state_dict(st, [hook]),
                        host_state={})
        got = extract_model_params(tmp_path / "last", _port_net(key))
        for k, p in m.named_parameters():
            assert torch.equal(got[k], p), k


def _resnet_state_dict(widths, rng):
    """A torchvision-named basic-block resnet state_dict (2 blocks a stage,
    a 7x7 stem and a head) of random numpy tensors at ``widths``."""
    sd = {"conv1.weight": rng.standard_normal((widths[0], 3, 7, 7)),
          "bn1.weight": rng.standard_normal(widths[0]), "fc.weight": rng.standard_normal((9, 8))}
    cin = widths[0]
    for i, c in enumerate(widths, 1):
        for j in range(2):
            pre = f"layer{i}.{j}"
            sd[f"{pre}.conv1.weight"] = rng.standard_normal((c, cin if j == 0 else c, 3, 3))
            sd[f"{pre}.conv2.weight"] = rng.standard_normal((c, c, 3, 3))
            for bn in ("bn1", "bn2"):
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{pre}.{bn}.{leaf}"] = rng.uniform(0.5, 1.5, c)
            if j == 0 and i > 1:
                sd[f"{pre}.downsample.0.weight"] = rng.standard_normal((c, cin, 1, 1))
                sd[f"{pre}.downsample.1.weight"] = rng.standard_normal(c)
        cin = c
    return {k: np.asarray(a, np.float32) for k, a in sd.items()}


def test_resnet_encoder_warm_start_matches_jax(variables, tmp_path):
    """An archive of ``tools/convert_torch_weights.py resnet-encoder`` warm-
    starts the port's ResUNet as JAX's trainer does: the same loaded and
    skipped paths, the loaded tensors bit for bit; the port's converter
    writes the same archive."""
    spec = importlib.util.spec_from_file_location("convert_torch_weights",
                                                  REPO / "tools" / "convert_torch_weights.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # the ResUNet's Conv2..Conv5 widths at max_channel 64, so most shapes match
    sd = _resnet_state_dict((8, 16, 32, 64), np.random.default_rng(6))
    tree = tool.convert_resnet_encoder(sd)
    jax.tree.map(np.testing.assert_array_equal, convert_resnet_encoder(sd), tree)
    path = str(tmp_path / "enc.npz")
    save_npz_tree(path, tree)
    v = variables["resunet"]
    archive = jload_npz(path)
    _, jlo_p, jsk_p = jmerge(v["params"], archive.get("params", {}))
    _, jlo_s, jsk_s = jmerge(v["batch_stats"], archive.get("batch_stats", {}))
    m = _loaded("resunet", variables)
    loaded, skipped = load_pretrained(m, path)
    assert loaded == jlo_p + jlo_s and skipped == jsk_p + jsk_s
    assert skipped and any("Conv5" in p for p in loaded)
    got = state_dict_to_flax(m.state_dict(), m)
    for p in loaded:
        coll, *rest = ("params" if p in jlo_p else "batch_stats"), *p.split("/")
        a, b = got[coll], archive[coll]
        for k in rest:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_get_arch_keyword_contract():
    """As JAX's ``get_arch``: ``checkpoint`` dropped, an unknown name
    ``KeyError``, a keyword the net has no field for ``TypeError`` naming
    it; the U-Net takes ``groupnorm`` (GroupNorm layers, min(8, C) groups,
    eps 1e-6) and refuses another norm."""
    m = get_arch("UNet", max_channel=16, norm="groupnorm", checkpoint="x", dtype=torch.float32)
    gns = [mod for mod in m.modules() if isinstance(mod, GroupNorm)]
    assert len(gns) == 22 and {g.eps for g in gns} == {1e-6} and gns[0].groups == 1
    with pytest.raises(KeyError):
        get_arch("smp")
    with pytest.raises(TypeError, match="dtype, max_channel, momentum"):
        get_arch("unet2", dtype=torch.float32, max_channel=64, momentum=0.1)
    with pytest.raises(TypeError, match="norm"):
        get_arch("resunet", norm="groupnorm")
    with pytest.raises(ValueError, match="instancenorm"):
        get_arch("unet", max_channel=16, norm="instancenorm")
