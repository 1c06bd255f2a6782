"""The cluster-plot path of the port (contrastyou_tpu_torch/
plot_pretrain_cluster.py, postprocess/cluster.py, the pretraining trainers
with the cluster presets' hooks) held against the JAX package and the root
plot_pretrain_cluster.py on the CPU.

- The pretrain step with config/hooks/udaiic.yaml's hooks cut to the
  decoder (``discreteMI/up_conv2`` at padding 1 and ``consistency``, made
  with ``is_pretrain=False`` as the plot script makes them) and with
  ccblocks2.yaml's block, against JAX's ``build_pretrain_step``: the bounds
  of tests/test_torch_pretrain.py (metrics rtol 1e-5, the block's ``cc``
  1e-3 as in tests/test_torch_ccblock.py; gradients and updates in L2).
- Hungarian matching: ``hungarian_match`` and ``cluster_alignment`` equal
  to JAX's on random maps and on relabelled copies of a reference.
- ``dump_cluster_maps``: given one set of weights and head parameters (f32,
  max_channel 128, 32 x 32), the per-batch maps, ``cluster_acc``,
  ``mapping`` and the set of files equal to the JAX script's.
- The CLI on a synthetic layout: the files of a run, and the default
  udaiic preset (``Conv5``'s pooled head) refused before training.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.hooks.creator import create_discrete_mi_consistency_hooks as jcreate_dmi
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.postprocess.cluster import cluster_alignment as jalign
from contrastyou_tpu.postprocess.cluster import hungarian_match as jmatch
from contrastyou_tpu_torch.data.png import read_png
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.hooks.creator import create_discrete_mi_consistency_hooks
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.plot_pretrain_cluster import (check_cluster_hooks,
                                                         downsample_labels,
                                                         dump_cluster_maps, main)
from contrastyou_tpu_torch.postprocess.cluster import (cluster_alignment, hungarian_match,
                                                       vote_matrix)
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_cluster_head_state_dict,
                                                        flax_to_state_dict)
from test_torch_ccblock import CC2
from test_torch_pretrain import OPTIM, SCHED, _batch, _check_step_against_jax
from test_torch_step import REPO

torch.set_num_threads(1)

S = 32
#: config/hooks/udaiic.yaml with the encoder hook left out, as the plot script
#: needs (its documented preset's Conv5 head pools the map)
UDAIIC_DECODER = {"feature_names": ["Up_conv2"], "mi_weights": [0.05], "dense_paddings": [1],
                  "consistency_weight": 1}
#: the plot CLI's overrides for that preset
UDAIIC_DECODER_ARGV = ["DiscreteMIConsistencyParams.feature_names=[Up_conv2]",
                       "DiscreteMIConsistencyParams.mi_weights=[0.05]"]


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


@pytest.mark.parametrize("sections,rtol,atol", [
    ({"DiscreteMIConsistencyParams": UDAIIC_DECODER}, {"": 1e-4}, 1e-7),
    ({"CrossCorrelationParameters": CC2}, {"/cc": 1e-3}, 0.0)], ids=["udaiic", "ccblocks2"])
def test_pretrain_step_with_cluster_hooks_matches_jax(sections, rtol, atol):
    """udaiic's metrics at the bounds of tests/test_torch_step.py's udaiic
    step (rtol 1e-4, atol 1e-7: ``reg_loss`` is 0.05 MI + consistency, ~2e-4
    after cancellation, and sits 2.6e-8 from JAX's)."""
    _check_step_against_jax("pretrain_decoder", _batch(), sections=sections, is_pretrain=False,
                            metric_rtol=rtol, metric_atol=atol)


def test_cut_with_cluster_hooks_matches_jax():
    """``feature_until_from_hooks`` as JAX's: a hook with no taps
    (consistency) alone leaves the forward whole, and udaiic's hooks cut it
    at their deepest tap."""
    from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
    from contrastyou_tpu.trainers.pretrain import feature_until_from_hooks as juntil
    from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
    from contrastyou_tpu_torch.trainers.pretrain import feature_until_from_hooks

    assert feature_until_from_hooks(ConsistencyTrainerHook()) == \
        juntil(JConsistency(weight=1.0)) == "Deconv_1x1"
    for kw in (UDAIIC_DECODER, dict(UDAIIC_DECODER, feature_names=["Conv5", "Up_conv2"],
                                    mi_weights=[0.1, 0.05])):
        hooks = create_discrete_mi_consistency_hooks(channel_dim=UNet(max_channel=128)
                                                     .get_channel_dim, **kw)
        assert feature_until_from_hooks(*hooks) == juntil(*jcreate_dmi(**kw)) == "Up_conv2"


@pytest.mark.parametrize("seed", range(4))
def test_hungarian_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 12))
    cluster = rng.integers(0, k, (3, 9, 11))
    reference = rng.integers(0, k, (3, 9, 11))
    # a relabelled copy of the reference with some noise: the match recovers the labels
    perm = rng.permutation(k)
    noisy = np.where(rng.random(reference.shape) < 0.1, cluster, perm[reference])
    for c, r in ((cluster, reference), (noisy, reference)):
        assert hungarian_match(c, r, k) == jmatch(c, r, k)
        np.testing.assert_array_equal(cluster_alignment(c, r), jalign(c, r))
        np.testing.assert_array_equal(cluster_alignment(c, r, num_clusters=k),
                                      jalign(c, r, num_clusters=k))
    assert hungarian_match(noisy, reference, k) == {int(perm[i]): i for i in range(k)} or \
        (cluster_alignment(noisy, reference) == reference).mean() > 0.85
    votes = vote_matrix(cluster, reference, k)
    assert votes.sum() == cluster.size and votes[1, 2] == ((cluster == 1) & (reference == 2)).sum()


def test_downsample_labels_matches_jax():
    import plot_pretrain_cluster as jplot

    labels = np.random.default_rng(0).integers(0, 4, (3, 224, 224))
    for hw in ((224, 224), (56, 56), (17, 31)):
        np.testing.assert_array_equal(downsample_labels(labels, hw),
                                      jplot._downsample_labels(labels, hw))


def _loader_batches():
    rng = np.random.default_rng(3)
    return [{"image": rng.random((4, S, S, 1)).astype(np.float32),
             "target": rng.integers(0, 4, (4, S, S)).astype(np.int32),
             "partition": np.array([0, 1, 2, 0], np.int32)} for _ in range(2)]


def test_dump_cluster_maps_matches_jax(tmp_path):
    """One set of weights (JAX's initial U-Net and discreteMI/up_conv2 head,
    carried over by the bridge): the port's per-batch maps, ``cluster_acc``
    and ``mapping`` equal the JAX script's ``dump_cluster_maps``, and both
    write the same files (the port's PNGs decode as RGB)."""
    import plot_pretrain_cluster as jplot

    jbundle = JBundle.create(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                             jax.random.PRNGKey(0), (S, S, 1))
    jhooks = jcreate_dmi(**UDAIIC_DECODER)
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    jstate = jinit(jbundle, jhooks, tx, jax.random.PRNGKey(1))
    batches = _loader_batches()
    jres = jplot.dump_cluster_maps(types.SimpleNamespace(_hooks=jhooks, bundle=jbundle,
                                                         state=jstate),
                                   batches, tmp_path / "jax")

    params, stats, hparams = jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats,
                                                       jstate.hook_params))
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    hooks = create_discrete_mi_consistency_hooks(channel_dim=model.get_channel_dim,
                                                 **UDAIIC_DECODER)
    hooks[0].projector.load_state_dict(flax_to_cluster_head_state_dict(
        hparams[hooks[0].name]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = dump_cluster_maps(ModelBundle(model, (S, S, 1)), hooks, batches, tmp_path / "port",
                            device="cpu")
    assert res == jres
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    for bi in range(len(batches)):
        name = f"discreteMI_up_conv2_b{bi}"
        got, ref = (np.load(tmp_path / d / f"{name}.npy") for d in ("port", "jax"))
        assert got.dtype == ref.dtype and got.shape == (4, S, S)
        np.testing.assert_array_equal(got, ref)
        assert read_png(tmp_path / "port" / f"{name}.png", rgb=True).shape == (2 * S + 4,
                                                                             4 * S + 12, 3)
    assert read_png(tmp_path / "port" / "discreteMI_up_conv2_tsne.png",
                    rgb=True).shape == (900, 900, 3)
    # the running statistics are left alone
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_pooled_cluster_head_is_refused_before_training(tmp_path, monkeypatch):
    """The documented preset (config/hooks/udaiic.yaml: Conv5 and Up_conv2)
    raises ``NotImplementedError`` naming discreteMI/conv5 before anything
    trains; a preset with no cluster hook raises too."""
    data = tmp_path / "data"
    synthesize_acdc_like(data, num_train_scans=4, num_val_scans=2, slices_per_scan=6, size=40)
    monkeypatch.setattr(package, "DATA_PATH", str(data))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    argv = ["-p", str(REPO / "config/base.yaml"), str(REPO / "config/hooks/udaiic.yaml"),
            "-o", "Trainer.device=cpu", "Arch.max_channel=32", "Trainer.save_dir=plot",
            "+ContrastiveLoaderParams.scan_sample_num=2"]
    with pytest.raises(NotImplementedError, match="discreteMI/conv5"):
        main(argv)
    assert not (tmp_path / "runs" / "plot" / "last").exists()
    with pytest.raises(ValueError, match="no cluster-producing hook"):
        check_cluster_hooks([])


def test_cli_writes_the_cluster_plots(tmp_path, monkeypatch):
    """``python -m contrastyou_tpu_torch.plot_pretrain_cluster`` (in process)
    with udaiic cut to the decoder, 2 epochs x 2 steps on the CPU (bf16,
    max_channel 32): the pretraining run's files, then in cluster_plots/
    ``cluster_metrics.json`` (``cluster_acc`` in [0, 1], a bijective
    ``mapping``), a map and a montage a validation batch, the t-SNE PNG
    (900 x 900 RGB) and ``launches.json`` (no launch on the CPU, the
    t-SNE's size, the train epochs' timing records)."""
    data = tmp_path / "data"
    synthesize_acdc_like(data, num_train_scans=4, num_val_scans=3, slices_per_scan=6, size=64)
    monkeypatch.setattr(package, "DATA_PATH", str(data))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    res = main(["-p", str(REPO / "config/base.yaml"), str(REPO / "config/hooks/udaiic.yaml"),
                "-o", *UDAIIC_DECODER_ARGV, "Trainer.device=cpu", "Arch.max_channel=32",
                "Trainer.max_epoch=2", "Trainer.num_batches=2", "Trainer.save_dir=plot",
                "+ContrastiveLoaderParams.scan_sample_num=2"])
    run = tmp_path / "runs" / "plot"
    assert {"config.yaml", "storage.csv", "last", ".success", "cluster_plots"} <= \
        {p.name for p in run.iterdir()}
    out = run / "cluster_plots"
    metrics = json.loads((out / "cluster_metrics.json").read_text())
    assert metrics == json.loads(json.dumps(res)) and list(metrics) == ["discreteMI/up_conv2"]
    m = metrics["discreteMI/up_conv2"]
    assert 0.0 <= m["cluster_acc"] <= 1.0
    assert sorted(m["mapping"].values()) == sorted(int(k) for k in m["mapping"])
    maps = sorted(p.name for p in out.glob("*.npy"))
    assert maps and maps == [f"discreteMI_up_conv2_b{i}.npy" for i in range(len(maps))]
    assert {p.stem for p in out.glob("*.png")} == {p[:-4] for p in maps} | {
        "discreteMI_up_conv2_tsne"}
    assert read_png(out / "discreteMI_up_conv2_tsne.png", rgb=True).shape == (900, 900, 3)
    record = json.loads((out / "launches.json").read_text())
    tsne = record["tsne"]["discreteMI/up_conv2"]
    assert tsne["n"] == sum(np.load(out / m).shape[0] for m in maps)
    assert np.isfinite(tsne["kl_divergence"]) and not any(record["launches"]["train"].values())
    assert [t["epoch"] for t in record["timing"] if t["phase"] == "train"] == [0, 1]
