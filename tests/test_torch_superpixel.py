"""Superpixel InfoNCE (the port's hooks/infonce.py ``majority_pool_labels``
/ ``SuperPixelInfoNCEHook``, postprocess/superpixel.py) held against the JAX
package on the CPU, with the same numpy-seeded inputs and bridged weights
(its dense hook under ``semi``: tests/test_torch_semi_dense.py):

- ``majority_pool_labels`` on random maps of ids 0-255, ties included, and
  ``slic`` / ``generate_superpixels``: integer maps exactly equal;
- one ``pretrain_decoder`` step with ``InfonceSuperPixelParams`` against
  JAX ``build_pretrain_step`` on the same batch, weights and replayed draws,
  with the tolerances of tests/test_torch_pretrain.py (losses f32 rtol
  1e-5; gradients and updates L2 5e-2 per tensor and 2e-2 together; BN
  statistics 1e-4 of the largest value);
- the projection heads of both new hook kinds through the parameter bridge;
- the refusals: no superpixel map, an encoder superpixel hook, a superpixel
  hook on the device cache, a hook type pretraining does not take;
- a superpixel pretraining run through ``main.main`` on the CPU (1 epoch x 2
  steps; ``storage.csv``'s columns those of JAX's trainer) and a host-fed
  ``semi`` run with the superpixel hook.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import contrastyou_tpu_torch as package
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_from_config
from contrastyou_tpu.hooks.infonce import majority_pool_labels as jmajority
from contrastyou_tpu.postprocess.superpixel import generate_superpixels as jgenerate
from contrastyou_tpu.postprocess.superpixel import slic as jslic
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.png import read_png
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.hooks import StepContext
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.hooks.infonce import (INFONCEHook, SuperPixelInfoNCEHook,
                                                 majority_pool_labels)
from contrastyou_tpu_torch.main import build_pretrain_run, build_semi_run, parse_config
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.postprocess.superpixel import generate_superpixels, slic
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        head_state_dict_to_flax)
from test_torch_mt_loop import fast_jax_bundle  # noqa: F401 (a fixture)
from test_torch_pretrain import _check_step_against_jax, _hook_config
from test_torch_spinfonce import jax_storage_columns
from torch_parity import close

torch.set_num_threads(1)

S = 32


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


# --- majority pooling, SLIC ----------------------------------------------

@pytest.mark.parametrize("shape,grid,ids", [
    ((2, 32, 32), (4, 4), 256), ((3, 37, 45), (4, 5), 256), ((2, 32, 32), (16, 16), 2),
    ((2, 30, 30), (15, 10), 3), ((1, 64, 48), (8, 16), 256)])
def test_majority_pool_labels_matches_jax(shape, grid, ids):
    """Random maps (ids 0-255, or 2-3 distinct ids, where windows of 2 to 6
    pixels tie often), windows that do not divide the map, and a map whose
    every window ties: the smallest id wins, as jnp.argmax picks it."""
    rng = np.random.default_rng(sum(shape) + ids)
    values = rng.integers(0, 256, ids)
    maps = [values[rng.integers(0, ids, shape)]]
    tie = np.zeros(shape, np.int64)
    tie[:, :, 1::2] = 200                     # every even-width window: half 0, half 200
    maps.append(tie)
    ties = 0
    for m in maps:
        got = majority_pool_labels(torch.tensor(m), *grid)
        want = np.asarray(jmajority(jnp.asarray(m, jnp.int32), *grid))
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(), want)
        ties += int((got.numpy() == 0).sum())
    assert ties > 0


def test_majority_pool_labels_counts_only_ids_in_range():
    ids = torch.tensor([[[300, 300], [-1, 5]]])
    assert majority_pool_labels(ids, 1, 1).tolist() == [[[5]]]
    np.testing.assert_array_equal(
        majority_pool_labels(ids, 1, 1).numpy(),
        np.asarray(jmajority(jnp.asarray(ids.numpy(), jnp.int32), 1, 1)))


@pytest.mark.parametrize("shape,kw", [((224, 224), {}), ((64, 80), dict(n_segments=8)),
                                      ((100, 37), dict(n_segments=50, sigma=1.0)),
                                      ((48, 48), dict(compactness=0.5, n_iter=3))])
def test_slic_matches_jax(shape, kw):
    rng = np.random.default_rng(shape[0])
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for image in (rng.random(shape).astype(np.float32),
                  (0.5 + 0.4 * np.sin(yy / 9.0) * np.cos(xx / 7.0)).astype(np.float32)):
        got = slic(image, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jslic(image, **kw))


def test_generate_superpixels_matches_jax(tmp_path):
    synthesize_acdc_like(tmp_path / "p", num_train_scans=2, num_val_scans=1, slices_per_scan=3,
                         size=48)
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    for mode in ("train", "val"):
        assert (generate_superpixels(tmp_path / "p" / "ACDC_contrast", mode=mode, n_segments=12)
                == jgenerate(tmp_path / "j" / "ACDC_contrast", mode=mode, n_segments=12))
    files = sorted((tmp_path / "j").rglob("superpixel/*.png"))
    assert len(files) == 9
    for f in files:
        ours = tmp_path / "p" / f.relative_to(tmp_path / "j")
        np.testing.assert_array_equal(read_png(ours), np.asarray(Image.open(f)))


def _superpixels(n, seed):
    """[n, S, S] block maps of 8 x 8 pixel superpixels, ids shared across
    images (so positives span images), each image shifted a little."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    return np.stack([((yy + rng.integers(0, 8)) // 8 * 5 + (xx + rng.integers(0, 8)) // 8) % 13
                     for _ in range(n)]).astype(np.int32)


def test_superpixel_pretrain_decoder_step_matches_jax():
    image = np.random.default_rng(0).random((6, S, S, 1)).astype(np.float32)
    batch = {"image": image, "partition": np.array([0, 1, 2, 0, 1, 2]),
             "scan_id": np.repeat([0, 1], 3), "patient": np.repeat([1, 2], 3),
             "cycle": np.zeros(6, np.int64), "superpixel": _superpixels(6, 2)}
    _check_step_against_jax("pretrain_decoder", batch, grid=(8, 8), sections={
        "InfonceSuperPixelParams": {"feature_names": "Up_conv2", "weights": 1.0,
                                    "spatial_size": 8}})


# --- heads, refusals ---------------------------------------------------------

@pytest.mark.parametrize("section,names", [
    ({"SPInfonceParams": {"feature_names": ["Conv5", "Up_conv2"], "weights": 1.0,
                          "contrast_ons": ["partition", "self"]}},
     ["spinfonce/Conv5/partition", "spinfonce/Up_conv2/self"]),
    ({"InfonceSuperPixelParams": {"feature_names": ["Up_conv2", "Up_conv3"], "weights": 1.0,
                                  "spatial_size": [8, 4]}},
     ["infonce/Up_conv2/superpixel", "infonce/Up_conv3/superpixel"])])
def test_heads_cross_the_bridge(section, names):
    """JAX's initialized heads of both new hook kinds load into the port's
    (``flax_to_head_state_dict``), project the same features to the same
    vectors (f32 rtol 1e-5) and convert back unchanged."""
    width = UNet(max_channel=128).get_channel_dim
    config = _hook_config(section)
    jhooks, hooks = jcreate_from_config(config), create_hook_from_config(config,
                                                                       channel_dim=width)
    assert [h.name for h in hooks] == [h.name for h in jhooks] == names
    rng = np.random.default_rng(5)
    for jh, h in zip(jhooks, hooks):
        c = width(h.taps[0])
        feats = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
        jparams, _ = jh.init(jax.random.PRNGKey(3), type("B", (), {
            "get_channel_dim": staticmethod(width)})())
        h.projector.load_state_dict(flax_to_head_state_dict(jparams))
        want = jh._projector.apply({"params": jparams}, jnp.asarray(feats))
        close(h.projector(torch.tensor(feats)), want, rtol=1e-5, atol=1e-6, what=h.name)
        back = head_state_dict_to_flax(h.projector.state_dict())
        for layer, leaves in jparams.items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(back[layer][k], np.asarray(v))


def merge_sections(trainer, sections):
    """The in-code config of ``trainer`` on the CPU with hook ``sections`` added."""
    cfg = parse_config(["-o", f"Trainer.name={trainer}", "Trainer.device=cpu"])
    cfg.update(sections)
    return cfg


def test_superpixel_hook_refusals():
    with pytest.raises(ValueError, match="decoder"):
        SuperPixelInfoNCEHook(name="x", feature_name="Conv5", in_dim=256)
    hook = SuperPixelInfoNCEHook(name="sp", feature_name="Up_conv2", in_dim=32,
                                 spatial_size=(4, 4))
    feats = torch.zeros(2, S, S, 32)
    ctx = StepContext(unlabeled_taps={"Up_conv2": feats}, unlabeled_tf_taps={"Up_conv2": feats})
    with pytest.raises(ValueError, match="acdc_superpixel"):
        hook.loss(ctx, {})
    cfg = merge_sections("semi", {"InfonceSuperPixelParams": {
        "feature_names": "Up_conv2", "weights": 1.0, "spatial_size": 4}})
    with pytest.raises(ValueError, match="device_cache=false"):
        build_semi_run(cfg, device="cpu", dtype=torch.float32, raw_size=40, crop=S, n_slices=8,
                       max_channel=128)


def test_new_sections_build_under_every_trainer():
    """``SPInfonceParams`` and ``InfonceSuperPixelParams`` build under
    ``pretrain`` and ``pretrain_decoder`` (the hook types pretraining admits
    by name) and under ``semi``; a subclass outside that list is refused."""
    from contrastyou_tpu_torch.trainers.pretrain import check_pretrain_hooks

    sp = {"SPInfonceParams": {"feature_names": "Conv5", "weights": 1.0,
                              "contrast_ons": "partition"}}
    spx = {"InfonceSuperPixelParams": {"feature_names": "Up_conv2", "weights": 1.0,
                                       "spatial_size": 4}}
    size = dict(device="cpu", dtype=torch.float32, raw_size=36, crop=S, max_channel=128)
    run = build_pretrain_run(merge_sections("pretrain", sp), n_scans=6, **size)
    assert [h.name for h in run.hooks] == ["infonce/Conv5/partition", "spinfonce/Conv5/partition"]
    m = run.step(run.state, run.generator)
    assert float(m["spinfonce/Conv5/partition/age_param"]) == 1e10
    run = build_pretrain_run(merge_sections("pretrain_decoder", {**sp, **spx}), n_scans=6, **size)
    assert run.until == "Up_conv2" and run.hooks[-1].name == "infonce/Up_conv2/superpixel"
    semi = build_semi_run(merge_sections("semi", sp), n_slices=8, **size)
    assert [h.name for h in semi.hooks] == ["spinfonce/Conv5/partition", "consistency"]
    assert np.isfinite(float(semi.step(semi.state, semi.generator)["total_loss"]))

    class Other(INFONCEHook):
        pass

    with pytest.raises(NotImplementedError, match="other"):
        check_pretrain_hooks([Other(name="other", feature_name="Conv5", in_dim=256)])


# --- the loops ---------------------------------------------------------------

SPX = ["+InfonceSuperPixelParams.feature_names=Up_conv2", "+InfonceSuperPixelParams.weights=1.0",
       "+InfonceSuperPixelParams.spatial_size=16", "Data.name=acdc_superpixel",
       "Trainer.device=cpu", "Arch.max_channel=16", "Trainer.max_epoch=1",
       "Trainer.num_batches=2"]
PRE_ARGV = ["-o", "Trainer.name=pretrain_decoder", "~InfonceParams", *SPX,
            "Trainer.save_dir=spx", "ContrastiveLoaderParams.scan_sample_num=1"]
SEMI_ARGV = ["-o", "Trainer.name=semi", *SPX, "Trainer.save_dir=semi_spx"]


@pytest.fixture
def superpixel_layout(tmp_path, monkeypatch):
    """An ``acdc_superpixel`` layout: 4 train and 2 validation scans of 6
    slices at 32 x 32, superpixel maps from the port's SLIC."""
    synthesize_acdc_like(tmp_path / "data", num_train_scans=4, num_val_scans=2,
                         slices_per_scan=6, size=S)
    for mode in ("train", "val"):
        generate_superpixels(tmp_path / "data" / "ACDC_contrast", mode=mode, n_segments=8)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path


def test_superpixel_pretraining_loop_writes_jax_columns(superpixel_layout, fast_jax_bundle):
    assert port_main.main(PRE_ARGV) == 0
    run = superpixel_layout / "runs" / "spx"
    assert (run / ".success").exists() and (run / "last").is_dir()
    lines = (run / "storage.csv").read_text().splitlines()
    assert len(lines) == 2
    row = dict(zip(*(line.split(",") for line in lines)))
    assert np.isfinite(float(row["tra/infonce/Up_conv2/superpixel/metrics/Up_conv2/superpixel/"
                                 "loss"]))
    assert lines[0].split(",") == jax_storage_columns(port_main.parse_config(PRE_ARGV),
                                                      superpixel_layout)


def test_superpixel_semi_loop_runs_host_fed(superpixel_layout):
    """``semi`` with the superpixel hook: the host-fed loop carries the
    unlabeled batch's map; validation, test and inference run."""
    assert port_main.main(SEMI_ARGV) == 0
    run = superpixel_layout / "runs" / "semi_spx"
    for f in ("storage.csv", ".success", "best", "inference_result.json"):
        assert (run / f).exists(), f
    row = dict(zip(*(line.split(",") for line in (run / "storage.csv").read_text().splitlines())))
    assert np.isfinite(float(row["tra/infonce/Up_conv2/superpixel/metrics/Up_conv2/superpixel/"
                                 "loss"]))
    with pytest.raises(ValueError, match="device_cache=false"):
        port_main.main(SEMI_ARGV[:-1] + ["Trainer.save_dir=cached", "Trainer.device_cache=true"])
