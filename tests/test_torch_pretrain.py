"""One contrastive pretrain step of the port (contrastyou_tpu_torch/trainers/
pretrain.py, hooks/infonce.py) held against JAX ``build_pretrain_step`` on the
same batch, weights and draws, plus the contrastive samplers, the partition
rules, the dataset table, the pretrain configs, the prostate run and the
entry point's device rule.

Size: max_channel 128, 32x32 slices, 2 scans x 3 partitions = 6 slices (12
images through the forward), f32; the prostate step takes 48 slices (96
images, the batch from which the conv backward runs C1 / C2). The JAX step draws from its key
(pretrain.py ``jax.random.split(rng, 7)``: k1 feeds both view 1's
GeoParams and its gamma, ``sample_points`` splits its key per image and then
into rows and columns); the test replays those splits and hands the draws to
the port. The JAX optimizer is wrapped so its state also records the
gradients it was given.

Tolerances (f32). Losses rtol 1e-5 (measured 1e-6). Gradients: the same
sums in another order through the U-Net, whose train-mode BN backward at
this small batch subtracts terms far larger than its result, so they are
compared in L2: per tensor at 5e-2 (measured worst 2.0%, a BN scale of
Conv1) and over all backbone gradients together at 2e-2 (measured 0.7%).
This is the f32 noise of the network, not of the port: a 1e-7 relative
change of the input image moves the port's own gradients by up to 0.16%,
and the two frameworks' sums differ by ~1e-6. The update is RAdam's first
(unrectified) step, -lr * (grad + wd * param), at lr 0.1 so that it stands
well above the f32 resolution of the parameters; it is held to the
gradients' bounds. BN running statistics: 1e-4 of the largest value
(measured 1.1e-5). Frozen
layers must be bit-unchanged in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.hooks.creator import create_infonce_hooks as jcreate_hooks
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.models import trainable_mask as jtrainable_mask
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu.trainers.pretrain import build_pretrain_step as jbuild
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.data.datasets import DATASETS, dataset_spec
from contrastyou_tpu_torch.data.sampler import (ContrastBatchSampler, InfiniteRandomSampler,
                                                partition_index)
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import init_train_state
from contrastyou_tpu_torch.hooks.creator import create_infonce_hooks
from contrastyou_tpu_torch.main import (PRETRAIN_DECODER_CONFIG, PRETRAIN_ENCODER_CONFIG,
                                        build_pretrain_run, main, parse_config,
                                        resolve_device)
from contrastyou_tpu_torch.models.masks import trainable_mask
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops import convblock as cb
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.trainers.pretrain import (PretrainDraws, build_pretrain_step,
                                                     feature_until_from_hooks, frozen_after)
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        flax_to_state_dict,
                                                        head_state_dict_to_flax,
                                                        state_dict_to_flax)
from test_torch_step import REPO
from torch_parity import close, scaled_close, t

torch.set_num_threads(1)

S, P, JITTER = 32, 5, 0.5
PARTITION = np.array([0, 1, 2, 0, 1, 2])
OPTIM = {"name": "RAdam", "lr": 0.1, "weight_decay": 1e-2}
SCHED = {"multiplier": 400, "warmup_max": 10}
HOOKS = {
    "pretrain_decoder": dict(feature_names=["Conv5", "Up_conv2"], weights=[1.0, 0.5],
                             contrast_ons=["partition", "self"], spatial_size=[1, 16]),
    "pretrain": dict(feature_names="Conv5", weights=1.0, contrast_ons="partition",
                     spatial_size=1),
}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")


def _batch():
    image = np.random.default_rng(0).random((6, S, S, 1)).astype(np.float32)
    return {"image": image, "partition": PARTITION, "scan_id": np.repeat([0, 1], 3),
            "patient": np.repeat([1, 1], 3), "cycle": np.repeat([0, 1], 3)}


def _recording(tx):
    """``tx`` whose state also keeps the last gradients it was given."""
    def init(p):
        return {"inner": tx.init(p), "grads": jax.tree.map(jnp.zeros_like, p)}

    def update(u, s, p=None):
        upd, inner = tx.update(u, s["inner"], p)
        return upd, {"inner": inner, "grads": u}

    return optax.GradientTransformation(init, update)


def _jax_step(hook_kw, batch, key, data_name="acdc", jitter=JITTER, num_classes=4):
    bundle = JBundle.create(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32,
                                  num_classes=num_classes),
                            jax.random.PRNGKey(0), (S, S, 1))
    hooks = jcreate_hooks(data_name=data_name, **hook_kw)
    until = max((h.taps[0] for h in hooks), key=JUNet.arch_elements.index)

    def labels(trainables):
        params, hook_params = trainables
        mask = jtrainable_mask(params, elements=JUNet.arch_elements, enable=False,
                               start=until, include_start=False)
        return (jax.tree.map(lambda m: "train" if m else "freeze", mask),
                jax.tree.map(lambda _: "train", hook_params))

    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200, param_labels=labels)
    tx = _recording(tx)
    state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
    before = jax.tree.map(np.asarray, (state.params, state.batch_stats, state.hook_params))
    step = jbuild(bundle, tx, hooks, until=until, color_jitter=jitter)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                        jnp.int32(0))
    return hooks, before, jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, metrics)


def _geo(key, b):
    return GeoParams(*(torch.tensor(np.asarray(v)) for v in sample_geo_params(key, b)))


def _uniform(key, b, lo, hi):
    return t(jax.random.uniform(key, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)


def _replayed_draws(key, b, grid, strength=JITTER):
    k1, k2, k_geo, k_int, k_hook, kj1, kj2 = jax.random.split(key, 7)

    def jitter(k):
        kb, kc = jax.random.split(k)
        return (_uniform(kb, b, 1 - strength, 1 + strength),
                _uniform(kc, b, 1 - strength, 1 + strength))

    ys, xs = [], []
    for k in jax.random.split(k_hook, b):
        kh, kw = jax.random.split(k)
        ys.append(np.asarray(jax.random.choice(kh, grid[0], (P,), replace=False)))
        xs.append(np.asarray(jax.random.choice(kw, grid[1], (P,), replace=False)))
    return PretrainDraws(
        g1=_geo(k1, b), gammas1=_uniform(k1, b, 0.5, 2.0),
        g2=_geo(k2, b), gammas2=_uniform(k2, b, 0.5, 2.0),
        jitter1=jitter(kj1), jitter2=jitter(kj2),
        geo=_geo(k_geo, b), gammas_int=_uniform(k_int, b, 0.5, 2.0),
        points={grid: (torch.tensor(np.stack(ys)).long(), torch.tensor(np.stack(xs)).long())})


def _l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


#: L2 bounds (per tensor, all tensors together) of the step's gradients and updates
L2_TOL = (5e-2, 2e-2)


def _check_l2(pairs, what, tol=L2_TOL):
    """Per tensor L2 <= tol[0]; over all tensors together <= tol[1]."""
    for name, a, b in pairs:
        assert _l2(a, b) <= tol[0], f"{what} {name}: {_l2(a, b):.3e}"
    together = _l2(np.concatenate([np.ravel(a) for _, a, _ in pairs]),
                   np.concatenate([np.ravel(b) for _, _, b in pairs]))
    assert together <= tol[1], f"{what}, all together: {together:.3e}"


@pytest.mark.parametrize("trainer", ["pretrain_decoder", "pretrain"])
def test_pretrain_step_matches_jax(trainer):
    _check_step_against_jax(trainer, _batch())


def _check_step_against_jax(trainer, batch, data_name="acdc", num_classes=4, jitter=JITTER,
                            tol=L2_TOL):
    """One port step against the JAX step on ``batch``: metrics, gradients,
    updates, frozen layers and BN statistics (tolerances above)."""
    key = jax.random.PRNGKey(7)
    n = len(batch["image"])
    jhooks, (params, stats, hparams), jnew, jm = _jax_step(
        HOOKS[trainer], batch, key, data_name=data_name, jitter=jitter, num_classes=num_classes)

    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32, num_classes=num_classes)
    model.load_state_dict(flax_to_state_dict(params, stats))
    hooks = create_infonce_hooks(channel_dim=model.get_channel_dim, **HOOKS[trainer])
    for h in hooks:
        h.projector.load_state_dict(flax_to_head_state_dict(hparams[h.name]))
    until = feature_until_from_hooks(*hooks)
    assert until == ("Up_conv2" if trainer == "pretrain_decoder" else "Conv5")
    trainable = frozen_after(until)
    opt, _ = create_optimizer([p for k, p in model.named_parameters() if trainable(k)]
                              + hook_parameters(hooks), OPTIM, SCHED, max_epoch=75,
                              steps_per_epoch=200)
    bundle = ModelBundle(model, (S, S, 1))
    state = init_train_state(bundle, hooks, opt)
    step = build_pretrain_step(bundle, hooks, until=until)
    m = step(state, {k: torch.tensor(v) for k, v in batch.items()},
             _replayed_draws(key, n, (16, 16), jitter))

    assert set(m) == set(jm)
    for k in jm:
        close(m[k], jm[k], rtol=1e-5, atol=0, what=k)
    # gradients: backbone (trainable layers) and projection heads
    jgrads, jhgrads = jnew.opt_state["grads"]
    grads = state_dict_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                for k, p in model.state_dict(keep_vars=True).items()})
    _check_l2([(jax.tree_util.keystr(path), g, jg) for (path, g), jg in zip(
        jax.tree_util.tree_flatten_with_path(grads["params"])[0], jax.tree.leaves(jgrads))],
        "grad", tol)
    for h in hooks:
        hg = head_state_dict_to_flax({k: p.grad for k, p in h.projector.named_parameters()})
        _check_l2([(f"{layer}/{k}", v, jhgrads[h.name][layer][k])
                   for layer, leaves in hg.items() for k, v in leaves.items()], f"grad {h.name}",
                  tol)
    # updated parameters, frozen layers, BN statistics
    new = state_dict_to_flax(model.state_dict())
    frozen = [layer for layer in UNet.arch_elements
              if layer in new["params"] and not trainable(f"_{layer}.x")]
    assert ("Deconv_1x1" in frozen) and (trainer == "pretrain") == ("Up_conv5" in frozen)
    updates = []
    for layer in new["params"]:
        for (path, a), b, b0 in zip(
                jax.tree_util.tree_flatten_with_path(new["params"][layer])[0],
                jax.tree.leaves(jnew.params[layer]), jax.tree.leaves(params[layer])):
            what = f"{layer}{jax.tree_util.keystr(path)}"
            if layer in frozen:
                np.testing.assert_array_equal(a, b0, err_msg=what)
                np.testing.assert_array_equal(b, b0, err_msg=what)
            else:
                updates.append((what, a - b0, b - b0))
    _check_l2(updates, "update", tol)
    for h in hooks:
        _check_l2([(f"{layer}/{k}", v - hparams[h.name][layer][k],
                    jnew.hook_params[h.name][layer][k] - hparams[h.name][layer][k])
                   for layer, leaves in head_state_dict_to_flax(h.projector.state_dict()).items()
                   for k, v in leaves.items()], f"update {h.name}", tol)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jnew.batch_stats)):
        scaled_close(a, b, tol=1e-4, what=f"stats {jax.tree_util.keystr(path)}")


def test_contrast_sampler_yields_the_jax_indices():
    from contrastyou_tpu.data.sampler import ContrastBatchSampler as JSampler

    names = [f"patient{p:03d}_{c:02d}" for p in (1, 2, 3, 4) for c in (0, 1)]
    sizes = [7, 9, 8, 10, 6, 9, 11, 8]
    stems, scans, parts = [], [], []
    for name, size in zip(names, sizes):
        for i in range(size):
            stems.append(f"{name}_{i:02d}")
            scans.append(name)
            parts.append(partition_index(i, size))

    class Dataset:
        def get_stem_list(self):
            return stems

        def get_scan_name(self, stem):
            return stem[:13]

        def get_partition(self, stem):
            return parts[stems.index(stem)]

    for shuffle, k in ((False, 1), (True, 2)):
        ref = iter(JSampler(Dataset(), scan_sample_num=6, partition_sample_num=k,
                            shuffle=shuffle, seed=3))
        got = iter(ContrastBatchSampler(scans, parts, scan_sample_num=6,
                                        partition_sample_num=k, shuffle=shuffle, seed=3))
        for _ in range(5):
            assert next(got) == next(ref)
    assert ContrastBatchSampler(scans, parts, scan_sample_num=6).batch_size == 18


def test_partition_rule_matches_the_dataset():
    """The 3-way threshold rule of data/base.py ``get_partition``."""
    assert [partition_index(i, 10) for i in range(10)] == [0, 0, 0, 1, 1, 1, 1, 2, 2, 2]
    # more than 3 partitions: cur // (cut + 1), capped
    assert [partition_index(i, 9, 4) for i in range(9)] == [0, 0, 0, 1, 1, 1, 2, 2, 2]


def test_freeze_predicate_matches_the_jax_mask():
    v = jax.eval_shape(lambda: JUNet(max_channel=128).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), train=False))
    jmask = jtrainable_mask(v["params"], elements=JUNet.arch_elements, enable=False,
                            start="Conv5", include_start=False)
    pred = trainable_mask(elements=UNet.arch_elements, enable=False, start="Conv5",
                          include_start=False)
    for name, _ in UNet(max_channel=128).named_parameters():
        layer = name.split(".")[0].lstrip("_")
        assert pred(name) == jax.tree.leaves(jmask[layer])[0], name
    assert frozen_after("Deconv_1x1")("_Deconv_1x1.weight")


@pytest.mark.parametrize("config,files", [
    (PRETRAIN_DECODER_CONFIG, ("config/hooks/infonce.yaml",)),
    (PRETRAIN_ENCODER_CONFIG, ("config/hooks/infonce_encoder.yaml",))])
def test_pretrain_configs_equal_the_yaml_files(config, files):
    cfg = yaml_load(REPO / "config/base.yaml")
    for f in ("config/pretrain.yaml", *files):
        cfg = merge(cfg, yaml_load(REPO / f))
    assert config == cfg
    assert parse_config(["-o", f"Trainer.name={cfg['Trainer']['name']}"]) == cfg
    paths = [str(REPO / f) for f in ("config/base.yaml", "config/pretrain.yaml", *files)]
    assert parse_config(["-p", *paths]) == cfg


def test_entry_point_runs_on_the_card_unless_asked():
    """No silent CPU fallback: without a card the entry point raises unless
    the caller asks for the CPU with ``Trainer.device=cpu``."""
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = parse_config(["-o", "Trainer.name=pretrain", "Trainer.device=cpu"])
    assert cfg["Trainer"]["device"] == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="Trainer.device=cpu"):
        resolve_device()
    with pytest.raises(RuntimeError):
        main(["-o", "Trainer.name=pretrain_decoder", "Trainer.num_batches=1"])


#: C1 / C2 calls of one decoder step at max_channel 128 from batch 96
KERNEL_CALLS_128 = {"conv_dw_taps": 4, "conv3x3_bwd_fused": 19}


def _prostate_batch(n=48):
    """A prostate contrastive batch: ``n`` slices (6 scans x 8 partitions at
    the reference's 48), so the forward sees 2n = 96 images."""
    image = np.random.default_rng(1).random((n, S, S, 1)).astype(np.float32)
    scan = np.arange(n) // 8
    return {"image": image, "partition": np.arange(n) % 8, "scan_id": scan,
            "patient": scan + 1, "cycle": np.zeros(n, np.int64)}


def _routing_calls(monkeypatch):
    """Count the C1 / C2 calls the conv backward makes (plain on the CPU)."""
    calls = {"conv_dw_taps": 0, "conv3x3_bwd_fused": 0}
    for name in calls:
        fn = getattr(cb, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cb, name, wrapper)
    return calls


def test_prostate_pretrain_step_matches_jax(monkeypatch):
    """The prostate ``pretrain_decoder`` step at its reference batch: 48
    slices, 96 images through the forward, 2 classes, colour jitter 0.1.
    Its conv backward takes the batch-96 routing and still matches the JAX
    step on its XLA path. At max_channel 128 every level of at most 64
    channels is on the kernel path (Conv1-Conv4, Up4-Up2, Up_conv5-Up_conv2):
    C1 for Conv1.conv0 and the taps of Up4, Up3 and Up2, C2 for the 19 conv
    inputs of Cin >= 8, skips included (at full width: 2 and 9).

    This network is ~3.4x as sensitive as the 6-slice ACDC step's: a 1e-7
    relative change of the input moves the port's own backbone gradients by
    0.26% in L2 (0.08% for ACDC), and port vs JAX sits at 2.9% together,
    4.7% for the worst tensor (a BN scale of Conv2) with or without the
    batch-96 routing (both measured on the CPU). So the L2 bounds scale with
    it: 1e-1 per tensor, 5e-2 together; metrics, heads, frozen layers and BN
    statistics keep the bounds above."""
    calls = _routing_calls(monkeypatch)
    _check_step_against_jax("pretrain_decoder", _prostate_batch(), data_name="prostate",
                            num_classes=2, jitter=0.1, tol=(1e-1, 5e-2))
    assert calls == KERNEL_CALLS_128


def test_random_sampler_yields_the_jax_indices():
    """Single process: the same seed gives the same index stream as the JAX
    ``InfiniteRandomSampler`` (across permutation boundaries), and the batches
    are its consecutive runs, as JAX ``BatchLoader`` cuts them."""
    import itertools

    from contrastyou_tpu.data.sampler import InfiniteRandomSampler as JSampler

    for size, seed in ((37, 10), (12, 0), (100, 3)):
        ref = list(itertools.islice(iter(JSampler(size, seed=seed, process_index=0,
                                                  process_count=1)), 3 * size + 5))
        got = list(itertools.islice(iter(InfiniteRandomSampler(size, seed)), 3 * size + 5))
        assert got == ref
        batches = InfiniteRandomSampler(size, seed).batches(7)
        assert [next(batches) for _ in range(5)] == [ref[i:i + 7] for i in range(0, 35, 7)]


def test_partition_rules_match_get_partition():
    """Both rules of data/base.py ``get_partition`` (3-way threshold for 3
    partitions, ``cur // (cut + 1)`` above), called on a stand-in dataset,
    for every dataset's partition count and scan lengths up to prostate's."""
    from contrastyou_tpu.data.base import SliceDataset

    class Scans:
        _scan_info = None
        get_partition = SliceDataset.get_partition
        _threshold_partition = SliceDataset._threshold_partition

        def __init__(self, partition_num, counts):
            self.partition_num, self._scan_slice_count = partition_num, counts

        def get_scan_name(self, stem):
            return stem.rsplit("_", 1)[0]

    for partition_num in sorted({s.partition_num for s in DATASETS.values()}):
        ds = Scans(partition_num, {f"Case{n:02d}": n for n in range(1, 65)})
        for n in range(1, 65):
            assert [partition_index(i, n, partition_num) for i in range(n)] == \
                [ds.get_partition(f"Case{n:02d}_{i:02d}") for i in range(n)], (partition_num, n)
    assert sorted({partition_index(i, 64, 8) for i in range(64)}) == list(range(8))


def test_dataset_table_matches_the_jax_datasets():
    """``dataset_spec`` == the class attributes of contrastyou_tpu/data/
    datasets.py for every dataset, and each synthetic scan name is matched
    by the dataset's own grouping pattern."""
    import re

    from contrastyou_tpu.data.datasets import dataset_spec as jspec
    from contrastyou_tpu.data.datasets import data_zoo

    assert set(DATASETS) == set(data_zoo)
    for name, spec in DATASETS.items():
        ref = jspec(name)
        assert (spec.num_classes, spec.partition_num, spec.group_re) == \
            (ref["num_classes"], ref["partition_num"], ref["group_re"]), name
        scan = spec.scan_name.format(patient=7, cycle=1 % spec.cycles)
        assert re.fullmatch(spec.group_re, scan), (name, scan)
    with pytest.raises(KeyError):
        dataset_spec("nope")


def test_prostate_run_builds_48_slice_batches(monkeypatch):
    """``-o Data.name=prostate``: 2 classes, 8 partitions filled in the
    synthetic scans, random 48-slice batches (96 images per forward) and one
    finite step through the batch-96 backward (plain C1 / C2 on the CPU);
    ACDC keeps its 18-slice partition batches."""
    calls = _routing_calls(monkeypatch)
    cfg = parse_config(["-o", "Trainer.name=pretrain_decoder", "Data.name=prostate",
                        "Trainer.device=cpu"])
    run = build_pretrain_run(cfg, device="cpu", raw_size=36, crop=S, max_channel=128,
                             n_scans=4, dtype=torch.float32)
    assert run.batch_slices == 48
    assert run.state.model._Deconv_1x1.out_channels == 2
    assert sorted(set(run.cache.partition.tolist())) == list(range(8))
    m = run.step(run.state, run.generator)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert calls == KERNEL_CALLS_128
    acdc = build_pretrain_run(parse_config(["-o", "Trainer.name=pretrain", "Trainer.device=cpu"]),
                              device="cpu", raw_size=36, crop=S, max_channel=128, n_scans=6,
                              dtype=torch.float32)
    assert acdc.batch_slices == 18
    assert acdc.state.model._Deconv_1x1.out_channels == 4
