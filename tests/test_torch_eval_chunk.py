"""Chunked evaluation in the port (contrastyou_tpu_torch/engine/steps.py
``build_scanned_eval_step``, engine/trainer.py ``Trainer.eval_epoch``) held
against JAX's ``build_scanned_eval_step`` and ``Trainer.eval_epoch`` on the
CPU. The U-Net at max_channel 128 (JAX's least width), f32, 32 x 32 slices,
the port's seeded weights with running statistics drawn away from 0 and 1,
bridged to JAX (``utils/torch_convert.py``).

- The scanned step on a chunk of 3 batches (one whole, one half masked, one
  a padded batch of no real slice), plain and multicore
  (``prob_transform``, 8 prototypes summed to 4 classes): each batch's loss
  to rtol 1e-5, the padded batch's 0; per-sample counts equal but where an
  argmax near-tie (the port's top two probabilities within 1e-5) may flip a
  pixel between the two frameworks' f32 forwards: each sample's counts may
  differ by at most its near-tie pixels, whose number the test prints;
  masked rows' counts 0.
- ``Trainer.eval_epoch`` with ``EVAL_CHUNK`` 2 (JAX's set to 2 as well) on
  2 scans (one chunk) and on 3 (a chunk and a padded one), for ``semi``,
  ``mt`` (evaluated on its teacher, whose weights differ from the
  student's) and ``multicore``: every chunk's losses and counts as above,
  one loss a real batch, the per-scan DSC and the pass's statistics equal
  to JAX's where no count differs.
- Two gloo ranks (tests/torch_dp.py ``eval_worker``): a pass of 4-slice
  batches (sharded on the batch axis: two collectives a chunk) and one of
  5-slice batches (not divisible by 2: whole on every rank, none): the
  statistics equal to one process's (the loss to 1e-6, its numerators
  summed over the ranks in another order), and the sharded pass against
  JAX's ``eval_epoch`` on ``make_mesh(2)`` (the loss to 1e-5, DSC within
  2e-3: a near-tie pixel moves one scan's dice by ~1/|union|).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine.steps import build_scanned_eval_step as jbuild_scanned
from contrastyou_tpu.losses.multicore import MultiCoreKL as JMultiCoreKL
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.parallel import make_mesh
from contrastyou_tpu.trainers import SemiTrainer as JSemiTrainer
from contrastyou_tpu.trainers.multicore import prototype_groups as jgroups
from contrastyou_tpu_torch.data.creator import create_tra_test_dataset, split_dataset
from contrastyou_tpu_torch.data.loader import BatchLoader
from contrastyou_tpu_torch.data.sampler import ScanBatchSampler
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.steps import build_scanned_eval_step
from contrastyou_tpu_torch.losses.multicore import MultiCoreKL
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import state_dict_to_flax
from contrastyou_tpu_torch.trainers.multicore import prototype_groups
from torch_dp import eval_trainer, eval_worker, spawn

torch.set_num_threads(1)

S, MC, C, TIE, CHUNK = 32, 128, 4, 1e-5, 2


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")


def _weights(num_classes: int = C, seed: int = 0) -> dict:
    """The port's seeded U-Net state dict, running statistics redrawn."""
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32, num_classes=num_classes)
    model.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 4)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.tensor(rng.normal(0.0, 0.3, v.shape), dtype=v.dtype))
        elif k.endswith("running_var"):
            v.copy_(torch.tensor(rng.uniform(0.5, 2.0, v.shape), dtype=v.dtype))
    return sd


def _port_model(sd: dict, num_classes: int = C) -> UNet:
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32, num_classes=num_classes)
    model.load_state_dict(sd)
    return model


def _jax_bundle(sd: dict, num_classes: int = C) -> JBundle:
    flax = state_dict_to_flax(sd)
    return JBundle(JUNet(max_channel=MC, dtype=jnp.float32, num_classes=num_classes),
                   flax["params"], flax["batch_stats"], (S, S, 1))


def _transforms(multicore: bool):
    if not multicore:
        return None, None
    return (MultiCoreKL(prototype_groups(C, 2)).reduced_simplex,
            JMultiCoreKL(jgroups(C, 2)).reduced_simplex)


def _near_ties(model, images, prob_transform) -> np.ndarray:
    """[K, B] pixels whose top two class probabilities (after
    ``prob_transform``) are within TIE in the port's forward."""
    out = []
    with torch.no_grad():
        for x in images:
            p = torch.softmax(model(torch.as_tensor(x), train=False)[0], -1)
            p = p if prob_transform is None else prob_transform(p)
            top2 = p.topk(2, -1).values
            out.append(((top2[..., 0] - top2[..., 1]) <= TIE).flatten(1).sum(1).numpy())
    return np.stack(out)


def _check_chunk(got, want, ties, masks, what: str) -> int:
    """One chunk's (loss, inter, union), port against JAX: losses to rtol
    1e-5, each sample's counts within its near-tie pixels, masked rows 0;
    -> the count entries that differ."""
    loss, inter, union = (np.asarray(x, np.float64) for x in got)
    jloss, jinter, junion = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0, err_msg=what)
    allow = (ties * masks)[..., None]
    for a, b in ((inter, jinter), (union, junion)):
        assert (np.abs(a - b) <= allow).all(), (what, np.abs(a - b).max(), allow.max())
        assert not a[~masks.astype(bool)].any(), what
    return int((inter != jinter).sum() + (union != junion).sum())


@pytest.mark.parametrize("multicore", [False, True])
def test_scanned_eval_step_matches_jax(multicore):
    classes = 2 * C if multicore else C
    sd = _weights(classes)
    rng = np.random.default_rng(1)
    images = rng.random((3, 3, S, S, 1)).astype(np.float32)
    targets = rng.integers(0, C, (3, 3, S, S)).astype(np.int32)
    masks = np.array([[True] * 3, [True, True, False], [False] * 3])
    transform, jtransform = _transforms(multicore)
    jb = _jax_bundle(sd, classes)
    want = jbuild_scanned(jb, prob_transform=jtransform, target_num_classes=C)(
        jb.params, jb.batch_stats, jnp.asarray(images), jnp.asarray(targets), jnp.asarray(masks))
    model = _port_model(sd, classes)
    scanned = build_scanned_eval_step(ModelBundle(model, (S, S, 1)), prob_transform=transform,
                                      target_num_classes=C)
    got = scanned(model, torch.tensor(images), torch.tensor(targets), torch.tensor(masks))
    assert [tuple(x.shape) for x in got] == [(3,), (3, 3, C), (3, 3, C)]
    assert float(got[0][2]) == 0.0
    ties = _near_ties(model, images, transform)
    apart = _check_chunk(got, want, ties, masks, f"multicore={multicore}")
    print(f"multicore={multicore}: {int((ties * masks).sum())} near-tie pixels, "
          f"{apart} count entries apart")


# --- Trainer.eval_epoch --------------------------------------------------------------

@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """2 train scans; 3 validation scans of 4 slices and one of 5 at 32 x 32."""
    root = tmp_path_factory.mktemp("eval_chunk")
    synthesize_acdc_like(root, num_train_scans=2, num_val_scans=3, slices_per_scan=4, size=S)
    synthesize_acdc_like(root, num_train_scans=0, num_val_scans=1, slices_per_scan=5, size=S,
                         first_scan=6, seed=1)
    return root


def _batches(dataset) -> list:
    return list(BatchLoader(dataset, batch_sampler=ScanBatchSampler(dataset, shuffle=False),
                            infinite=False))


@pytest.fixture(scope="module")
def passes(layout):
    """name -> eval batches: ``even`` the three 4-slice scans, ``two`` the
    first two of them, ``odd`` all four scans (padded to 5 slices)."""
    _, test = create_tra_test_dataset("acdc", str(layout))
    four = [s for s in test.get_scan_list() if s != "patient006_00"]
    even, _ = split_dataset(test, len(four), seed=1)
    even = _batches(even)
    assert all(b["image"].shape[0] == 4 for b in even) and len(even) == 3
    odd = _batches(test)
    assert all(b["image"].shape[0] == 5 for b in odd) and len(odd) == 4
    return {"even": even, "two": even[:2], "odd": odd}


def _spec(layout) -> dict:
    return {"root": str(layout), "size": S, "max_channel": MC, "num_batches": 1, "world": 2}


class _Recorded:
    """A scanned eval step that keeps each call's inputs and outputs."""

    def __init__(self, fn, graph=None):
        self.fn, self.graph, self.calls = fn, graph, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls.append(([np.asarray(a) for a in args[-3:]], [np.asarray(o) for o in out]))
        return out


def _jax_trainer(tmp_path, sd, transform=None, classes=C, mesh=None):
    """JAX's trainer with the weights of ``sd`` (no init: only its eval
    pass runs), its chunk 2, its scanned step recorded."""
    jt = JSemiTrainer(model=None, labeled_loader=None, save_dir=str(tmp_path / "jax"),
                      prob_transform=transform, target_num_classes=C, mesh=mesh)
    jt._bundle = _jax_bundle(sd, classes)
    jt._state = types.SimpleNamespace(params=jt._bundle.params,
                                      batch_stats=jt._bundle.batch_stats)
    jt.EVAL_CHUNK = CHUNK
    jt._scanned_eval_step = _Recorded(jbuild_scanned(jt._bundle, prob_transform=transform,
                                                     target_num_classes=C))
    return jt


def _port_trainer(kind: str, layout, tmp_path, sd_student, sd_teacher=None):
    from contrastyou_tpu_torch.hooks.mt import MeanTeacherTrainerHook
    from contrastyou_tpu_torch.trainers import MTTrainer, MulticoreTrainer, SemiTrainer
    from torch_dp import OPTIM, SCHED
    from contrastyou_tpu_torch.data.creator import create_infinite_loader
    tra, _ = create_tra_test_dataset("acdc", str(layout))
    classes = 2 * C if kind == "multicore" else C
    model = _port_model(sd_student, classes)
    kw = dict(model=model, labeled_loader=create_infinite_loader(tra, batch_size=2),
              save_dir=str(tmp_path / kind), max_epoch=1, num_batches=1,
              config={"Optim": OPTIM, "Scheduler": SCHED})
    if kind == "multicore":
        trainer = MulticoreTrainer(true_num_classes=C, multiplier=2, **kw)
    elif kind == "mt":
        trainer = MTTrainer(**kw)
        trainer.register_hooks(MeanTeacherTrainerHook(weight=1.0, alpha=0.9))
    else:
        trainer = SemiTrainer(**kw)
    trainer.init()
    if sd_teacher is not None:
        state = trainer._state.hook_states["mt"]
        for k, v in sd_teacher.items():
            (state["teacher_params"] if k in state["teacher_params"]
             else state["teacher_batch_stats"])[k].copy_(v)
    trainer.EVAL_CHUNK = CHUNK
    scanned = trainer._scanned_eval()
    trainer._scanned_eval_step = _Recorded(scanned, scanned.graph)
    return trainer


def _dsc_by_scan(calls, batches) -> dict:
    """scan -> DSC [C] from the recorded chunks' counts: each chunk's rows
    are its batches' slots in order, then the padded batches' (no name)."""
    sums = {}
    for i, (_, (_, inter, union)) in enumerate(calls):
        chunk = batches[i * CHUNK:(i + 1) * CHUNK]
        names = [nm for b in chunk for nm in b["scan"]]
        for name, a, u in zip(names, inter.reshape(-1, C), union.reshape(-1, C)):
            if name is not None:
                s = sums.setdefault(name, np.zeros((2, C), np.int64))
                s += np.stack([a, u]).astype(np.int64)
    return {k: (2 * v[0] + 1e-16) / (v[1] + 1e-16) for k, v in sums.items()}


@pytest.mark.parametrize("kind", ["semi", "mt", "multicore"])
def test_eval_epoch_matches_jax(kind, layout, passes, tmp_path):
    classes = 2 * C if kind == "multicore" else C
    student = _weights(classes)
    teacher = _weights(classes, seed=7) if kind == "mt" else None
    evaluated = teacher if teacher is not None else student
    transform, jtransform = _transforms(kind == "multicore")
    trainer = _port_trainer(kind, layout, tmp_path, student, teacher)
    jt = _jax_trainer(tmp_path, evaluated, jtransform, classes)
    model = trainer._inference_state()
    for name in ("two", "even"):
        batches = passes[name]
        trainer._scanned_eval_step.calls.clear()
        jt._scanned_eval_step.calls.clear()
        stats, score = trainer.eval_epoch(batches, 0, name)
        jstats, jscore = jt.eval_epoch(batches, 0)
        calls, jcalls = trainer._scanned_eval_step.calls, jt._scanned_eval_step.calls
        assert len(calls) == len(jcalls) == (1 if name == "two" else 2)
        # the chunks: 2 real batches, then (3 scans) 1 real and 1 padded
        assert [c[0][2].any(1).tolist() for c in calls] == [c[0][2].any(1).tolist()
                                                           for c in jcalls]
        apart, ties_total = 0, 0
        for i, (((x, _, m), out), (_, jout)) in enumerate(zip(calls, jcalls)):
            ties = _near_ties(model, x, transform)
            ties_total += int((ties * m).sum())
            apart += _check_chunk(out, jout, ties, m, f"{kind} {name} chunk {i}")
        print(f"{kind} {name}: {ties_total} near-tie pixels, {apart} count entries apart")
        np.testing.assert_allclose(stats["eval"]["loss"], jstats["eval"]["loss"], rtol=1e-5)
        dsc, jdsc = _dsc_by_scan(calls, batches), _dsc_by_scan(jcalls, batches)
        assert set(dsc) == set(jdsc) == {nm for b in batches for nm in b["scan"] if nm}
        if apart == 0:
            for k in dsc:
                np.testing.assert_array_equal(dsc[k], jdsc[k], err_msg=k)
            assert stats["eval"]["dice"] == pytest.approx(jstats["eval"]["dice"], abs=1e-12)
            assert score == pytest.approx(jscore, abs=1e-12)


# --- two ranks ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_runs(layout, passes, tmp_path_factory):
    out = tmp_path_factory.mktemp("eval_ranks")
    job = {"spec": _spec(layout), "model": _weights(), "chunk": CHUNK,
           "passes": {k: passes[k] for k in ("even", "odd")}}
    torch.save(job, out / "job.pt")
    spawn(eval_worker, 2, str(out / "job.pt"), str(out))
    one = eval_trainer(job, str(out / "one"))
    single = {k: one.eval_epoch(v, 0, k)[0] for k, v in job["passes"].items()}
    return job, [torch.load(out / f"eval_rank{r}.pt") for r in range(2)], single


@pytest.mark.parametrize("name", ["even", "odd"])
def test_eval_on_two_ranks_equals_one_process(rank_runs, name):
    _, ranks, single = rank_runs
    want = single[name]["eval"]
    for r in ranks:
        got = r[name]["stats"]["eval"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert got["dice"] == pytest.approx(want["dice"], abs=1e-12)
    assert ranks[0][name]["stats"] == ranks[1][name]["stats"]
    chunks = 2
    assert ranks[0][name]["collectives"] == (
        {"all_reduce": chunks, "all_gather": chunks} if name == "even"
        else {"all_reduce": 0, "all_gather": 0})


def test_sharded_eval_matches_jax_mesh(rank_runs, tmp_path):
    job, ranks, _ = rank_runs
    jt = _jax_trainer(tmp_path, job["model"], mesh=make_mesh(2))
    jstats, _ = jt.eval_epoch(job["passes"]["even"], 0)
    got = ranks[0]["even"]["stats"]["eval"]
    np.testing.assert_allclose(got["loss"], jstats["eval"]["loss"], rtol=1e-5)
    for k, v in jstats["eval"]["dice"].items():
        assert abs(got["dice"][k] - v) <= 2e-3, (k, got["dice"][k], v)
    assert jt._scanned_eval_step.calls[0][0][0].shape[:2] == (CHUNK, 4)
