"""The adversarial trainer of the port (contrastyou_tpu_torch/trainers/adv.py,
models/discriminator.py, the constant schedule of engine/optim.py, the
discriminator's weight bridge in utils/torch_convert.py) held against the
JAX package on the CPU.

- The discriminator's forward on converted weights, train mode (batch
  statistics, the running ones moved) and eval mode, f32: output rtol 1e-5,
  running statistics rtol 1e-5; the bridge both ways bit for bit.
- One adversarial step (f32, max_channel 128, 32 x 32, batches 2 + 2,
  ``reg_weight`` 0.5 so the adversarial terms are not negligible) against
  JAX's ``build_adversarial_step``, two steps: the three losses rtol 1e-4
  (the second step's 1e-3, after updates carrying JAX's f32 noise), both
  networks' parameter updates per tensor 1e-1 and over all 5e-2 in L2
  (JAX's f32 gradient noise, tests/test_torch_multicore.py), both networks' BN
  statistics 1e-3 of the largest value. With ``dis_consider_image`` too.
- ``create_optimizer`` without a ``Scheduler``: a constant learning rate, as
  optax's ``constant_schedule``.
- JAX's checkpoint finding: JAX's ``AdversarialTrainer`` saves its
  ``_state``, which its step never updates, so ``last`` holds the
  segmenter's initial weights (asserted on the JAX trainer itself). The
  port's ``main.main`` with ``Trainer.name=adv`` writes the files JAX's
  trainer writes (no ``inference_result.json``), ``storage.csv``'s header
  equal to JAX's, a checkpoint with the initial segmenter, and refuses a
  resume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import trainer as jtrainer_module
from contrastyou_tpu.engine.checkpoint import load_checkpoint as jload_checkpoint
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.models.discriminator import Discriminator as JDiscriminator
from contrastyou_tpu.trainers import adv as jadv
from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.models.discriminator import Discriminator
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.trainers import adv
from contrastyou_tpu_torch.trainers import trainer_zoo
from contrastyou_tpu_torch.utils.torch_convert import (discriminator_state_dict_to_flax,
                                                        flax_to_discriminator_state_dict,
                                                        flax_to_state_dict, state_dict_to_flax)
from torch_parity import close, n, scaled_close, t

torch.set_num_threads(1)

NL, NU, S, C = 2, 2, 32, 4
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _l2(a, b):
    a, b = np.ravel(n(a)), np.ravel(n(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _disc_vars(input_dim, seed=0):
    """JAX's initial discriminator variables, running statistics moved away
    from 0 and 1."""
    jd = JDiscriminator(input_dim=input_dim, dtype=jnp.float32)
    v = jd.init(jax.random.PRNGKey(seed), jnp.zeros((2, S, S, input_dim)), train=False)
    rng = np.random.default_rng(seed)
    stats = {k: {"mean": rng.normal(0, 0.3, a["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, a["var"].shape).astype(np.float32)}
             for k, a in v["batch_stats"].items()}
    return jd, jax.tree.map(np.asarray, v["params"]), stats


def _port_disc(params, stats, input_dim):
    d = Discriminator(input_dim=input_dim, dtype=torch.float32)
    d.load_state_dict(flax_to_discriminator_state_dict(params, stats))
    return d


def test_discriminator_matches_jax():
    jd, params, stats = _disc_vars(C)
    x = np.random.default_rng(1).dirichlet(np.ones(C), (3, S, S)).astype(np.float32)
    d = _port_disc(params, stats, C)
    back = discriminator_state_dict_to_flax(d.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"batch_stats": stats,
                                                            "params": params})):
        assert np.array_equal(a, b)
    out, mut = jd.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    close(d(t(x), train=True), out, rtol=1e-5, atol=1e-6, what="train")
    got = discriminator_state_dict_to_flax(d.state_dict())["batch_stats"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(mut["batch_stats"])):
        close(a, b, rtol=1e-5, atol=1e-6, what="running statistics")
    before = {k: v.clone() for k, v in d.state_dict().items()}
    d(t(x), train=True, update_stats=False)
    assert all(torch.equal(before[k], v) for k, v in d.state_dict().items())
    jeval = jd.apply({"params": params, "batch_stats": mut["batch_stats"]}, jnp.asarray(x),
                     train=False)
    close(d(t(x), train=False), jeval, rtol=1e-5, atol=1e-6, what="eval")


def test_constant_schedule_without_scheduler():
    opt, schedule = create_optimizer([torch.nn.Parameter(torch.zeros(2))], OPTIM, None,
                                     max_epoch=3, steps_per_epoch=4)
    _, jschedule = jcreate(OPTIM, None, max_epoch=3, steps_per_epoch=4)
    for count in (0, 1, 7, 100):
        assert schedule(count) == pytest.approx(float(jschedule(count)), rel=1e-7)
    assert schedule(0) == schedule(50) == OPTIM["lr"]


def _unet(seed):
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(seed))
    return state_dict_to_flax(model.state_dict())


@pytest.mark.parametrize("consider_image", [False, True])
def test_adversarial_step_matches_jax(consider_image):
    reg = 0.5
    tree = _unet(2)
    input_dim = C + (1 if consider_image else 0)
    jd, dparams, dstats = _disc_vars(input_dim, seed=3)
    rng = np.random.default_rng(4)
    batch = {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
             "labeled_target": rng.integers(0, C, (NL, S, S)).astype(np.int32),
             "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}
    jb = JBundle(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                 jax.tree.map(jnp.asarray, tree["params"]),
                 jax.tree.map(jnp.asarray, tree["batch_stats"]), (S, S, 1))
    gen_tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    disc_tx, _ = jcreate(OPTIM, None, max_epoch=75, steps_per_epoch=200)
    jstate = jadv.AdvState(params=jb.params, batch_stats=jb.batch_stats,
                           opt_state=gen_tx.init(jb.params), disc_params=dparams,
                           disc_batch_stats=dstats, disc_opt_state=disc_tx.init(dparams),
                           step=jnp.int32(0))
    jstep = jadv.build_adversarial_step(jb, jd, gen_tx, disc_tx, reg_weight=reg,
                                        dis_consider_image=consider_image, num_classes=C)

    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(tree["params"], tree["batch_stats"]))
    disc = _port_disc(dparams, dstats, input_dim)
    gen_opt, _ = create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75,
                                  steps_per_epoch=200)
    disc_opt, _ = create_optimizer(disc.parameters(), OPTIM, None, max_epoch=75,
                                   steps_per_epoch=200)
    step = adv.build_adversarial_step(model, disc, gen_opt, disc_opt, reg_weight=reg,
                                      dis_consider_image=consider_image, num_classes=C)
    for i in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step({k: torch.tensor(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in ("sup_loss", "gen_loss", "dis_loss"):
            # the second step's losses are taken after updates that carry
            # JAX's f32 gradient noise (tests/test_torch_multicore.py)
            close(m[k], jm[k], rtol=1e-4 if i == 0 else 1e-3, atol=1e-7, what=f"step {i} {k}")
        assert float(m["gen_loss"]) > 0 and float(m["dis_loss"]) > 0
    got = state_dict_to_flax(model.state_dict())
    dgot = discriminator_state_dict_to_flax(disc.state_dict())
    # the bounds of tests/test_torch_multicore.py's steps: JAX's f32
    # gradient of this U-Net lies ~4e-2 from its own f64 on Conv1's BN
    # scales, and the second discriminator update reads the probabilities
    # of segmenters that far apart
    for ours, theirs, init, what, bounds in (
            (got["params"], jstate.params, tree["params"], "segmenter", (1e-1, 5e-2)),
            (dgot["params"], jstate.disc_params, dparams, "discriminator", (1e-1, 5e-2))):
        upd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(ours),
                                                              jax.tree.leaves(init))]
        jupd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(theirs),
                                                               jax.tree.leaves(init))]
        assert max(_l2(a, b) for a, b in zip(upd, jupd)) <= bounds[0], what
        assert _l2(np.concatenate([np.ravel(a) for a in upd]),
                   np.concatenate([np.ravel(a) for a in jupd])) <= bounds[1], what
    for ours, theirs in ((got["batch_stats"], jstate.batch_stats),
                         (dgot["batch_stats"], jstate.disc_batch_stats)):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            scaled_close(a, b, tol=1e-3, what="statistics")


# --- the loop --------------------------------------------------------------------

SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2",
         "Trainer.num_batches=2", "Trainer.max_epoch=1", "Trainer.device=cpu",
         "Arch.max_channel=32"]


@pytest.fixture
def layout(tmp_path, monkeypatch):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=3, num_val_scans=2,
                         slices_per_scan=4, size=48)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def _jax_adv_run(cfg, tmp_path, monkeypatch):
    """JAX's ``AdversarialTrainer`` of ``cfg`` (max_channel 128, f32, its
    bundle from the port's initial weights of seed 0) after ``max_epoch`` x
    ``num_batches`` steps -> (trainer, initial params, storage header)."""
    def create(cls, model, rng, input_shape, batch=2):
        port = UNet(max_channel=128, momentum=0.01, dtype=torch.float32).init_weights(
            torch.Generator().manual_seed(0))
        tree = jax.tree.map(jnp.asarray, state_dict_to_flax(port.state_dict()))
        return cls(model, tree["params"], tree["batch_stats"], tuple(input_shape))

    monkeypatch.setattr(jtrainer_module.ModelBundle, "create", classmethod(create))
    loaders = jget_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                        root_dir=package.DATA_PATH)
    trainer = jadv.AdversarialTrainer(
        model=JUNet(max_channel=128, momentum=0.01, dtype=jnp.float32),
        labeled_loader=loaders[0], unlabeled_loader=loaders[1], val_loader=loaders[2],
        test_loader=loaders[3], save_dir=str(tmp_path / "jax"),
        max_epoch=int(cfg["Trainer"]["max_epoch"]),
        num_batches=int(cfg["Trainer"]["num_batches"]),
        config={"Optim": cfg["Optim"], "Scheduler": cfg["Scheduler"]}, seed=10,
        reg_weight=float(cfg["Trainer"]["reg_weight"]))
    trainer.init()
    initial = jax.tree.map(np.asarray, trainer._state.params)
    trainer.start_training()
    header = (tmp_path / "jax" / "storage.csv").read_text().splitlines()[0].split(",")
    return trainer, initial, header


@pytest.mark.parametrize("name", sorted(jtrainer_zoo))
def test_main_runs_inference_as_jax_main_does(name):
    """JAX's root main ends a run with inference when the trainer is not a
    pretraining one and has an ``inference`` method; the port's trainers
    declare it (``runs_inference``), and ``adv`` runs none."""
    want = name not in port_main.PRETRAIN_TRAINERS and hasattr(jtrainer_zoo[name], "inference")
    assert trainer_zoo[name].runs_inference is want
    assert want is (name not in ("adv", *port_main.PRETRAIN_TRAINERS))


def test_adv_loop_writes_jax_files_and_refuses_a_resume(layout, tmp_path, monkeypatch):
    argv = ["-o", "Trainer.name=adv", "Trainer.save_dir=adv", *SMALL]
    cfg = port_main.parse_config(argv)
    assert cfg["Trainer"]["reg_weight"] == 0.01 and trainer_zoo["adv"] is adv.AdversarialTrainer
    assert port_main.ADV_CONFIG == merge(yaml_load(port_main.Path(__file__).resolve().parents[1]
                                                   / "config/base.yaml"),
                                         yaml_load(port_main.Path(__file__).resolve().parents[1]
                                                   / "config/hooks/adv.yaml"))
    # JAX's trainer: its checkpoint holds the initial segmenter, not the trained one
    jtrainer, initial, jheader = _jax_adv_run(cfg, tmp_path, monkeypatch)
    saved = jax.tree.map(np.asarray, jtrainer_module.restore_train_state(
        jtrainer._state, jload_checkpoint(tmp_path / "jax" / "last")["train_state_bytes"]).params)
    trained = jax.tree.map(np.asarray, jtrainer._adv_state.params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(saved),
                                                     jax.tree.leaves(initial)))
    assert not all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(trained),
                                                         jax.tree.leaves(initial)))
    assert not (tmp_path / "jax" / "inference_result.json").exists()

    model_start = {}
    original_init = adv.AdversarialTrainer.init

    def init(self):
        original_init(self)
        model_start.update({k: v.clone() for k, v in self._model.state_dict().items()})

    monkeypatch.setattr(adv.AdversarialTrainer, "init", init)
    assert port_main.main(argv) == 0
    run = layout / "adv"
    for f in (".success", "last/train_state.pt", "best/train_state.pt", "config.yaml"):
        assert (run / f).exists(), f
    assert not (run / "inference_result.json").exists()
    lines = (run / "storage.csv").read_text().splitlines()
    header, row = lines[0].split(","), dict(zip(*(line.split(",") for line in lines[:2])))
    assert header == jheader
    assert np.isfinite(float(row["tra/adv_reg/dis_loss/value"]))
    saved = torch.load(run / "last/train_state.pt", weights_only=True)["model"]
    assert all(torch.equal(saved[k], v) for k, v in model_start.items())
    with pytest.raises(NotImplementedError, match="resuming an adversarial run"):
        port_main.main([*argv, "Trainer.max_epoch=2"])
