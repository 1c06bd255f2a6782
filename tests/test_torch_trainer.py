"""The port's experiment loop (contrastyou_tpu_torch/engine/{steps,trainer,
checkpoint}.py, trainers/semi.py, main.py) held against the JAX package.

- Eval step, f32, on bridged weights with running statistics away from
  their initial values: loss to 1e-5 of its value, class probabilities (one
  pass and the four-flip TTA average) to 1e-5 of the largest, predictions
  equal at every pixel whose top two JAX probabilities differ by more than
  1e-5 (the rest, near-ties the two frameworks' summation orders may
  order either way, are counted and printed; their dice counts may differ
  by at most their number). bf16: as accurate as JAX bf16, measured against
  JAX f32 (at most twice JAX bf16's distance plus 1% of the largest value,
  the convention of tests/test_torch_unet.py).
- A whole f32 run on the CPU through ``run_experiment`` (2 epochs): JAX's
  ``Trainer.eval_epoch`` on the port's last weights and ``SemiTrainer
  .inference`` on its best weights (converted back with
  ``utils/torch_convert.py``) give the port's validation and inference
  losses to 1e-5 and dice within 2e-3 per class (a pixel whose argmax flips
  at a near-tie moves one scan's dice by ~1/|union|; measured below 1e-5).
- The CLI (``main.main``, bf16, the README's small width) writes every file
  and resumes from ``last/`` (host-fed: the loaders restart from their
  seeds, so only the continuation is checked); with the device cache, two
  epochs in one run equal one epoch, a resume and one more, bitwise.
- JAX's ``yaml_load`` reads the port's ``config.yaml`` back as the config.
"""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.configure import yaml_load as jyaml_load
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine.steps import build_eval_step as jbuild_eval
from contrastyou_tpu.engine.steps import tta_probs as jtta
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.trainers import SemiTrainer as JSemiTrainer
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint
from contrastyou_tpu_torch.engine.steps import build_eval_step, tta_probs
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import flax_to_state_dict, state_dict_to_flax
from torch_parity import n, scaled_close

B, S, C = 3, 32, 4
TIE = 1e-5
SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2",
         "UnlabeledLoader.batch_size=2", "Trainer.num_batches=2", "Trainer.device=cpu"]


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """3 train scans of 4 slices, 3 validation scans (one of 6 slices, so an
    eval batch is padded) at 64 x 64."""
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=3, num_val_scans=2, slices_per_scan=4, size=64)
    synthesize_acdc_like(root, num_train_scans=0, num_val_scans=1, slices_per_scan=6, size=64,
                         first_scan=6, seed=1)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


# --- eval step ------------------------------------------------------------

def _weights():
    """Initial U-Net parameters; running statistics drawn away from 0 and 1."""
    v = JUNet(max_channel=128, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 1)), train=False)
    rng = np.random.default_rng(4)

    def stat(path, a):
        var = jax.tree_util.keystr(path).endswith("['var']")
        return (rng.uniform(0.5, 2.0, a.shape) if var
                else rng.normal(0.0, 0.3, a.shape)).astype(np.float32)

    return (jax.tree.map(np.asarray, v["params"]),
            jax.tree_util.tree_map_with_path(stat, v["batch_stats"]))


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((B, S, S, 1)).astype(np.float32),
            rng.integers(0, C, (B, S, S)).astype(np.int32), np.array([True, True, False]))


def _port_model(params, stats, dtype=torch.float32):
    m = UNet(max_channel=128, momentum=0.01, dtype=dtype)
    m.load_state_dict(flax_to_state_dict(params, stats))
    return m


def _jax_probs(dtype, params, stats, x, tta):
    bundle = JBundle(JUNet(max_channel=128, dtype=dtype), params, stats, (S, S, 1))
    if tta:
        return np.asarray(jtta(bundle, params, stats, jnp.asarray(x), lambda p: p))
    return np.asarray(jax.nn.softmax(bundle.apply_eval(params, stats, jnp.asarray(x))[0], -1))


@pytest.mark.parametrize("tta", [False, True])
def test_eval_step_matches_jax(tta):
    params, stats = _weights()
    x, y, mask = _batch()
    jbundle = JBundle(JUNet(max_channel=128, dtype=jnp.float32), params, stats, (S, S, 1))
    jloss, jpred, jinter, junion = (np.asarray(a) for a in jbuild_eval(jbundle, tta=tta)(
        params, stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    model = _port_model(params, stats)
    step = build_eval_step(ModelBundle(model, (S, S, 1)), tta=tta)
    loss, pred, inter, union = step(model, torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    assert not loss.requires_grad
    scaled_close(loss, jloss, tol=1e-5, what="loss")
    jp = _jax_probs(jnp.float32, params, stats, x, tta)
    probs = (tta_probs(model, torch.tensor(x)) if tta
             else torch.softmax(model(torch.tensor(x), train=False)[0], -1))
    scaled_close(probs, jp, tol=1e-5, what="probs")
    top2 = np.sort(jp, -1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0]) <= TIE
    print(f"tta={tta}: {int(ties.sum())} near-tie pixels of {ties.size}")
    np.testing.assert_array_equal(pred.numpy()[~ties], jpred[~ties])
    per_sample = ties.reshape(B, -1).sum(1)[:, None] * mask[:, None]
    assert (np.abs(inter.numpy() - jinter) <= per_sample).all()
    assert (np.abs(union.numpy() - junion) <= 2 * per_sample).all()
    assert not inter[~torch.tensor(mask)].any() and not union[~torch.tensor(mask)].any()


@pytest.mark.parametrize("tta", [False, True])
def test_eval_bf16_as_accurate_as_jax(tta):
    params, stats = _weights()
    x = _batch()[0]
    ref = _jax_probs(jnp.float32, params, stats, x, tta)
    jerr = np.abs(_jax_probs(jnp.bfloat16, params, stats, x, tta) - ref).max()
    model = _port_model(params, stats, torch.bfloat16)
    got = n(tta_probs(model, torch.tensor(x)) if tta
            else torch.softmax(model(torch.tensor(x), train=False)[0], -1))
    err = np.abs(got - ref).max()
    print(f"tta={tta}: bf16 max |p - p_f32|: port {err:.3e}, JAX {jerr:.3e}")
    assert err <= 2 * jerr + 0.01 * np.abs(ref).max()


# --- whole runs -----------------------------------------------------------

def _csv_rows(path):
    lines = path.read_text().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, line.split(","))) for line in lines[1:]]


def _dice(row, stage):
    return {k.rsplit("/", 1)[1]: float(v) for k, v in row.items()
            if k.startswith(f"{stage}/eval/dice/")}


def test_run_matches_jax_eval_and_inference(paths, tmp_path):
    """f32, max_channel 128 (the JAX U-Net's least width)."""
    cfg = port_main.parse_config(["-o", "Trainer.name=semi", "Trainer.max_epoch=2",
                                  "Arch.max_channel=128", "Trainer.save_dir=f32", *SMALL])
    trainer = port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32)
    run = paths / "f32"
    rows = _csv_rows(run / "storage.csv")
    assert len(rows) == 2 and trainer.cur_epoch >= 1
    jloaders = jget_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                         root_dir=package.DATA_PATH)
    jtrainer = JSemiTrainer(model=JUNet(max_channel=128, momentum=0.01, dtype=jnp.float32),
                            labeled_loader=jloaders[0], unlabeled_loader=jloaders[1],
                            val_loader=jloaders[2], test_loader=jloaders[3],
                            save_dir=str(tmp_path / "jax"), max_epoch=2, num_batches=2,
                            config={"Optim": cfg["Optim"], "Scheduler": cfg["Scheduler"]},
                            two_stage=True, seed=10)
    jtrainer.init()

    def load(name):
        flax = state_dict_to_flax(load_checkpoint(run / name)["train_state"]["model"])
        jtrainer._state = jtrainer._state.replace(
            params=jax.tree.map(jnp.asarray, flax["params"]),
            batch_stats=jax.tree.map(jnp.asarray, flax["batch_stats"]))

    load("last")
    jstats, _ = jtrainer.eval_epoch(jloaders[2], 1)
    got = _dice(rows[1], "val")
    want = jstats["eval"]["dice"]
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    scaled_close(float(rows[1]["val/eval/loss/value"]), jstats["eval"]["loss"], tol=1e-5,
                 what="val loss")
    load("best")
    jresult = jtrainer.inference()
    result = json.loads((run / "inference_result.json").read_text())
    for k in jresult["dice"]:
        assert abs(result["dice"][k] - jresult["dice"][k]) <= 2e-3, k
    for k in jresult["asd"]:
        assert np.isnan(jresult["asd"][k]) == np.isnan(result["asd"][k]), k
    scaled_close(result["loss"], jresult["loss"], tol=1e-5, what="inference loss")
    print("val dice", got, "jax", want)
    assert jyaml_load(run / "config.yaml") == cfg


def _argv(save_dir, epochs, *extra):
    return ["-o", "Trainer.name=semi", f"Trainer.max_epoch={epochs}", "Arch.max_channel=32",
            f"Trainer.save_dir={save_dir}", *SMALL, *extra]


def test_cli_writes_every_file_and_resumes(paths):
    """The README's small CPU run (bf16, max_channel 32): every file, then a
    second call with one more epoch resumes from ``last/``: its epoch
    count, the first rows of the history unchanged, the RAdam count of
    every step taken."""
    assert port_main.main(_argv("cli", 2)) == 0
    run = paths / "cli"
    for f in ("storage.csv", "config.yaml", ".success", "inference_result.json",
              "last/train_state.pt", "last/host_state.pkl", "best/train_state.pt"):
        assert (run / f).exists(), f
    first = (run / "storage.csv").read_text().splitlines()
    result = json.loads((run / "inference_result.json").read_text())
    assert np.isfinite(result["dice"]["DSC_mean"]) and np.isfinite(result["loss"])
    assert port_main.main(_argv("cli", 3)) == 0
    rows = (run / "storage.csv").read_text().splitlines()
    assert rows[:3] == first and len(rows) == 4
    ckpt = load_checkpoint(run / "last")
    assert ckpt["host_state"]["cur_epoch"] == 3
    assert ckpt["train_state"]["optimizer_count"] == ckpt["train_state"]["step"] == 6
    assert jyaml_load(run / "config.yaml") == port_main.parse_config(_argv("cli", 3))


def test_device_cache_resume_is_bitwise(paths):
    cache = "Trainer.device_cache=true"
    assert port_main.main(_argv("whole", 2, cache)) == 0
    assert port_main.main(_argv("split", 1, cache)) == 0
    assert port_main.main(_argv("split", 2, cache)) == 0
    assert (paths / "whole" / "storage.csv").read_text() == (
        paths / "split" / "storage.csv").read_text()
    a, b = (load_checkpoint(paths / r / "last")["train_state"] for r in ("whole", "split"))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["optimizer"]["state"].items():
        for name in v:
            assert torch.equal(v[name], b["optimizer"]["state"][k][name]), (k, name)
    assert a["optimizer_count"] == b["optimizer_count"] == 4


def test_jax_checkpoint_is_refused_by_name(paths, tmp_path):
    last = paths / "jaxrun" / "last"
    last.mkdir(parents=True)
    (last / "train_state.msgpack").write_bytes(b"\x80")
    with open(last / "host_state.pkl", "wb") as f:
        pickle.dump({"cur_epoch": 1}, f)
    with pytest.raises(ValueError, match="train_state.msgpack"):
        port_main.main(_argv("jaxrun", 2))
