"""Self-paced InfoNCE of the port (contrastyou_tpu_torch/losses/
contrastive.py ``self_paced_sup_con_loss``, hooks/infonce.py
``SelfPacedINFONCEHook``, hooks/creator.py ``create_sp_infonce_hooks``)
held against the JAX package on the CPU, with the same numpy-seeded inputs
and bridged weights:

- the loss for ``hard`` / ``soft`` weights, ``correct_grad`` off and on,
  labels and SimCLR pairs, and an age parameter that zeroes some weights:
  the loss (f32 rtol 1e-5), ``downgrade_ratio`` (rtol 1e-6) and the
  gradient of the loss to both views (L2 1e-5 per view: the same eager
  arithmetic, measured ~1e-7); ``SupConLoss`` / ``SelfPacedSupConLoss``;
- the hook's age parameter over the epochs (bit-equal f32), the factory's
  names, defaults and order, the sections that still raise;
- one ``pretrain`` step (encoder, by partition) and one ``pretrain_decoder``
  step (dense, the fixed 16 x 16 grid) with ``SPInfonceParams`` against
  JAX ``build_pretrain_step``, at an epoch inside the ramp, with the
  tolerances of tests/test_torch_pretrain.py (losses f32 rtol 1e-5;
  gradients and updates L2 5e-2 per tensor and 2e-2 together);
- a ``spinfonce`` pretraining run through ``main.main`` on the CPU (1 epoch
  x 2 steps): ``storage.csv``'s columns are those of JAX's trainer on the
  same layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_from_config
from contrastyou_tpu.hooks.infonce import SelfPacedINFONCEHook as JSPHook
from contrastyou_tpu.losses.contrastive import SelfPacedSupConLoss as JSPLoss
from contrastyou_tpu.losses.contrastive import SupConLoss as JSupConLoss
from contrastyou_tpu.losses.contrastive import self_paced_sup_con_loss as jsp_loss
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.hooks.creator import (PORTED_SECTIONS, SP_DENSE_GRID,
                                                 UNPORTED_SECTIONS, create_hook_from_config)
from contrastyou_tpu_torch.hooks.infonce import SelfPacedINFONCEHook
from contrastyou_tpu_torch.losses.contrastive import (SelfPacedSupConLoss, SupConLoss,
                                                      self_paced_sup_con_loss)
from contrastyou_tpu_torch.models.unet import UNet
from test_torch_mt_loop import fast_jax_bundle  # noqa: F401 (a fixture)
from test_torch_pretrain import S, _check_step_against_jax
from torch_parity import close, n

torch.set_num_threads(1)

N, D = 12, 32
#: a gamma under which the hard weights drop some positive pairs and the soft
#: ones shrink them all (the pairs' losses here lie between ~0.3 and ~6)
BITING_GAMMA = 2.5


def _views(seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(2, N, D)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return f[0], f[1]


def _l2(a, b):
    return np.linalg.norm(n(a) - n(b)) / max(np.linalg.norm(n(b)), 1e-30)


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("gamma", [1e10, BITING_GAMMA])
@pytest.mark.parametrize("correct_grad", [False, True])
@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_self_paced_loss_matches_jax(mode, correct_grad, gamma, labels):
    f1, f2 = _views()
    target = np.arange(N) % 3 if labels else None
    kw = dict(gamma=gamma, weight_update=mode, correct_grad=correct_grad, temperature=0.07)

    def jloss(a, b):
        return jsp_loss(a, b, target=None if target is None else jnp.asarray(target), **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(f1, f2)
    t1, t2 = (torch.tensor(x, requires_grad=True) for x in (f1, f2))
    loss, metrics = self_paced_sup_con_loss(
        t1, t2, target=None if target is None else torch.tensor(target), **kw)
    loss.backward()
    close(loss, jl, rtol=1e-5, atol=0, what="loss")
    close(metrics["downgrade_ratio"], jm["downgrade_ratio"], rtol=1e-6, atol=0, what="ratio")
    ratio = float(jm["downgrade_ratio"])
    if gamma == BITING_GAMMA:
        assert 0.0 < ratio < 1.0, ratio
    else:
        assert ratio == 1.0
    for got, want in zip((t1.grad, t2.grad), jg):
        assert _l2(got, want) <= 1e-5, _l2(got, want)


def test_self_paced_loss_aux_and_mask_match_jax():
    """``mask`` (1 positive, 0 negative) in place of labels, and the
    ``return_aux`` tensors."""
    f1, f2 = _views(1)
    mask = (np.add.outer(np.arange(N), np.arange(N)) % 2 == 0).astype(np.float32)
    jl, jm = jsp_loss(f1, f2, mask=jnp.asarray(mask), gamma=BITING_GAMMA, weight_update="soft",
                      return_aux=True)
    loss, m = self_paced_sup_con_loss(torch.tensor(f1), torch.tensor(f2),
                                      mask=torch.tensor(mask), gamma=BITING_GAMMA,
                                      weight_update="soft", return_aux=True)
    close(loss, jl, rtol=1e-5, atol=0, what="loss")
    assert set(m) == set(jm)
    for k in ("pos_mask", "sp_mask"):
        np.testing.assert_array_equal(n(m[k]), np.asarray(jm[k]), err_msg=k)
    close(m["sim_logits"], jm["sim_logits"], rtol=1e-5, atol=1e-5, what="sim_logits")
    with pytest.raises(ValueError, match="weight_update"):
        self_paced_sup_con_loss(torch.tensor(f1), torch.tensor(f2), gamma=1.0,
                                weight_update="medium")


def test_correct_grad_at_zero_ratio_is_finite():
    """Every positive weight zeroed: the loss is JAX's (0), and its gradient
    is 0 where JAX's ``where(ratio > 0, loss / ratio, loss)`` differentiates
    to 0 / 0 = NaN."""
    f1, f2 = _views(2)
    jl, jm = jsp_loss(f1, f2, gamma=1e-3, weight_update="hard", correct_grad=True)
    t1 = torch.tensor(f1, requires_grad=True)
    loss, m = self_paced_sup_con_loss(t1, torch.tensor(f2), gamma=1e-3, weight_update="hard",
                                      correct_grad=True)
    loss.backward()
    assert float(jm["downgrade_ratio"]) == float(m["downgrade_ratio"]) == 0.0
    assert float(loss.detach()) == float(jl) == 0.0
    jg = jax.grad(lambda a: jsp_loss(a, f2, gamma=1e-3, weight_update="hard",
                                     correct_grad=True)[0])(f1)
    assert np.isnan(np.asarray(jg)).all()
    assert torch.equal(t1.grad, torch.zeros_like(t1.grad))


def test_loss_wrappers_match_jax():
    f1, f2 = _views(3)
    target = np.arange(N) % 4
    close(SupConLoss(temperature=0.1)(torch.tensor(f1), torch.tensor(f2),
                                      target=torch.tensor(target)),
          JSupConLoss(temperature=0.1)(f1, f2, target=jnp.asarray(target)), rtol=1e-5, atol=0)
    ours, ref = SelfPacedSupConLoss(weight_update="soft"), JSPLoss(weight_update="soft")
    assert ours.age_param == ref.age_param == 1e6
    for gamma in (BITING_GAMMA, 4.0):
        ours.set_gamma(gamma)
        ref.set_gamma(gamma)
        assert ours.age_param == ref.age_param == gamma
        (a, am), (b, bm) = ours(torch.tensor(f1), torch.tensor(f2)), ref(f1, f2)
        close(a, b, rtol=1e-5, atol=0)
        close(am["downgrade_ratio"], bm["downgrade_ratio"], rtol=1e-6, atol=0)
    a, _ = ours(torch.tensor(f1), torch.tensor(f2), gamma=1.5)
    close(a, ref(f1, f2, gamma=1.5)[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("begin,end,p,max_epoch", [(1e10, 1e10, 0.5, 100), (100, 1e4, 0.5, 75),
                                                   (4.0, 10.0, 0.5, 10), (0.1, 7.3, 2.0, 33)])
def test_gamma_ramp_matches_jax(begin, end, p, max_epoch):
    """``begin + (end - begin) * (epoch / max_epoch) ** p`` in f32, bit-equal
    to JAX's at every epoch of the run."""
    kw = dict(name="sp", feature_name="Conv5", begin_value=begin, end_value=end, p=p,
              max_epoch=max_epoch)
    ours, ref = SelfPacedINFONCEHook(in_dim=16, **kw), JSPHook(**kw)
    for epoch in range(max_epoch + 1):
        got, want = ours.gamma(epoch), np.asarray(ref._gamma(jnp.int32(epoch)))
        assert got.dtype == torch.float32 and got.item() == want.item(), (epoch, got, want)


SP_SECTION = {"feature_names": ["Conv5", "Up_conv2"], "weights": [1.0, 0.5],
              "contrast_ons": ["partition", "self"]}


def _configs(sections, max_epoch=7):
    return {**sections, "Data": {"name": "acdc"}, "Trainer": {"max_epoch": max_epoch}}


def test_creator_names_defaults_and_order_match_jax():
    """``SPInfonceParams`` with JAX's defaults (begin = end = 1e10, soft,
    p 0.5, the fixed 16 x 16 grid of a dense hook, ``max_epoch`` from the
    trainer), and the hooks of every ported section in JAX's order."""
    width = UNet(max_channel=64).get_channel_dim
    ours = create_hook_from_config(_configs({"SPInfonceParams": SP_SECTION}), channel_dim=width)
    ref = jcreate_from_config(_configs({"SPInfonceParams": SP_SECTION}))
    assert [h.name for h in ours] == [h.name for h in ref] == [
        "spinfonce/Conv5/partition", "spinfonce/Up_conv2/self"]
    for a, b in zip(ours, ref):
        assert type(a) is SelfPacedINFONCEHook and a.weight == b.weight
        assert (a._begin, a._end, a._mode, a._p, a._max_epoch, a._correct_grad) == (
            b._begin, b._end, b._mode, b._p, b._max_epoch, b._correct_grad) == (
            1e10, 1e10, "soft", 0.5, 7, False)
    assert ours[0].grid is None and ours[1].grid == SP_DENSE_GRID == (16, 16)
    assert ref[1]._projector.spatial_size == SP_DENSE_GRID

    sections = {
        "InfonceParams": {"feature_names": "Conv5", "weights": 1.0, "contrast_ons": "patient",
                          "spatial_size": 1},
        "SPInfonceParams": {**SP_SECTION, "begin_values": [4, 5], "end_values": 9,
                            "mode": "hard", "p": 2, "correct_grad": [True, False]},
        "ConsistencyParameters": {"weight": 1.0},
        "InfonceSuperPixelParams": {"feature_names": "Up_conv2", "weights": 1.0,
                                    "spatial_size": 8},
        "EvalEMAParameters": {"alpha": 0.9}}
    ours = create_hook_from_config(_configs(sections), channel_dim=width)
    ref = jcreate_from_config(_configs(sections))
    assert [h.name for h in ours] == [h.name for h in ref]
    sp = [(h._begin, h._end, h._mode, h._p, h._correct_grad) for h in ours[1:3]]
    assert sp == [(h._begin, h._end, h._mode, h._p, h._correct_grad) for h in ref[1:3]] == [
        (4.0, 9.0, "hard", 2.0, True), (5.0, 9.0, "hard", 2.0, False)]
    assert "SPInfonceParams" in PORTED_SECTIONS and "InfonceSuperPixelParams" in PORTED_SECTIONS


#: the sections that were unported beside ``SPInfonceParams``, with a
#: body each; all but the differentiable mean teacher have a port since
CC_SECTION = {"feature_name": "Up_conv2", "num_clusters": 20, "head_type": "mlp",
              "hooks": {"cc": {"weight": 0.1, "kernel_size": 5}}}
OTHER_SECTIONS = {"DifferentiableMeanTeacherParameters": {"weight": 1.0},
                  "EntropyMinParameters": {"weight": 1.0}, "OrthogonalParameters": {"weight": 1.0},
                  "PsuedoLabelParams": {"weight": 1.0}, "MixUpParams": {"weight": 1.0},
                  "DAEParameters": {"weight": 1.0},
                  "FeatureCrossCorrelationParameters": CC_SECTION}


@pytest.mark.parametrize("section", list(OTHER_SECTIONS))
def test_every_other_unported_section_still_raises(section):
    """Beside ``SPInfonceParams``, a section without a port (those of
    ``UNPORTED_SECTIONS``) still raises naming itself; a section ported
    since builds its hook after the self-paced ones, named and ordered as
    JAX's factory does."""
    config = _configs({"SPInfonceParams": SP_SECTION, section: OTHER_SECTIONS[section]})
    width = UNet(max_channel=64).get_channel_dim
    if section in UNPORTED_SECTIONS:
        with pytest.raises(NotImplementedError, match=section):
            create_hook_from_config(config, channel_dim=width)
        return
    ours = create_hook_from_config(config, channel_dim=width)
    assert [h.name for h in ours] == [h.name for h in jcreate_from_config(config)]
    assert len(ours) == 3
    assert section in PORTED_SECTIONS or "CrossCorrelation" in section


def _pretrain_batch():
    image = np.random.default_rng(0).random((6, S, S, 1)).astype(np.float32)
    return {"image": image, "partition": np.array([0, 1, 2, 0, 1, 2]),
            "scan_id": np.repeat([0, 1], 3), "patient": np.repeat([1, 2], 3),
            "cycle": np.repeat([0, 1], 3)}


@pytest.mark.parametrize("trainer,section", [
    ("pretrain", {"feature_names": "Conv5", "weights": 1.0, "contrast_ons": "partition",
                  "begin_values": 2.0, "end_values": 30.0, "mode": "hard"}),
    ("pretrain_decoder", {"feature_names": ["Conv5", "Up_conv2"], "weights": [1.0, 0.5],
                          "contrast_ons": ["patient", "self"], "begin_values": 3.0,
                          "end_values": 6.0, "mode": "soft", "correct_grad": True})])
def test_sp_pretrain_step_matches_jax(trainer, section):
    """One pretraining step with ``SPInfonceParams`` at epoch 3 of 10 (gamma
    inside the ramp, low enough that the weights bite)."""
    _check_step_against_jax(trainer, _pretrain_batch(), sections={"SPInfonceParams": section},
                            epoch=3, grid=SP_DENSE_GRID)


# --- the loop ----------------------------------------------------------------

SP_ARGV = ["-o", "Trainer.name=pretrain", "~InfonceParams", "+SPInfonceParams.feature_names=Conv5",
           "+SPInfonceParams.weights=1", "+SPInfonceParams.contrast_ons=partition",
           "+SPInfonceParams.begin_values=100", "+SPInfonceParams.end_values=100",
           "+SPInfonceParams.mode=soft", "Trainer.device=cpu", "Arch.max_channel=16",
           "Trainer.max_epoch=1", "Trainer.num_batches=2", "Trainer.save_dir=sp",
           "ContrastiveLoaderParams.scan_sample_num=1"]


def jax_storage_columns(config: dict, tmp_path) -> list:
    """The ``storage.csv`` header of JAX's pretraining trainer on the config
    (its model at max_channel 128, f32), after ``max_epoch`` x
    ``num_batches`` steps."""
    from contrastyou_tpu.data import get_data as jget_data
    from contrastyou_tpu.models import UNet as JUNet
    from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
    from contrastyou_tpu.trainers.pretrain import get_contrastive_loader as jget_loader

    data = config["Data"]
    loaders = jget_data(data, {}, {}, root_dir=package.DATA_PATH, pretrain=True)
    clp = {k: v for k, v in config["ContrastiveLoaderParams"].items() if k != "num_workers"}
    trainer = jtrainer_zoo[config["Trainer"]["name"]](
        model=JUNet(max_channel=128, momentum=0.01, dtype=jnp.float32),
        labeled_loader=loaders[0], unlabeled_loader=loaders[1],
        contrast_loader=jget_loader(loaders[0].dataset, data_name=data["name"], seed=10, **clp),
        save_dir=str(tmp_path / "jax"), max_epoch=int(config["Trainer"]["max_epoch"]),
        num_batches=int(config["Trainer"]["num_batches"]),
        config={"Optim": config["Optim"], "Scheduler": config["Scheduler"]}, seed=10)
    trainer.register_hooks(*jcreate_from_config(config, is_pretrain=True, trainer=trainer))
    trainer.init()
    trainer.start_training()
    return (tmp_path / "jax" / "storage.csv").read_text().splitlines()[0].split(",")


def test_spinfonce_pretraining_loop_writes_jax_columns(tmp_path, monkeypatch, fast_jax_bundle):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=4, num_val_scans=2,
                         slices_per_scan=6, size=S)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    assert port_main.main(SP_ARGV) == 0
    run = tmp_path / "runs" / "sp"
    assert (run / ".success").exists() and (run / "last").is_dir()
    lines = (run / "storage.csv").read_text().splitlines()
    header, row = lines[0].split(","), dict(zip(*(line.split(",") for line in lines[:2])))
    assert len(lines) == 2
    # JAX's key: the hook name's first component stripped from the metric's
    metrics = "tra/spinfonce/Conv5/partition/metrics/Conv5/partition"
    assert row[f"{metrics}/age_param"] == "100.0"
    assert 0.0 < float(row[f"{metrics}/sp_weight"]) < 1.0
    assert all(np.isfinite(float(v)) for k, v in row.items() if k)
    assert header == jax_storage_columns(port_main.parse_config(SP_ARGV), tmp_path)
