"""``Trainer.unroll_steps`` = K in the port (contrastyou_tpu_torch/engine/
{steps,graph,trainer,optim}.py): K train steps a call, held against JAX's
``build_unrolled_train_step`` and ``build_cached_train_step(unroll=K)``, and
against K = 1 of the port itself. On the CPU the K steps run as a loop (the
card's CUDA graph of a call is held against eager steps by
tests/test_torch_cuda.py and chip_smoke.py).

- (a) The unrolled step at K = 2 against JAX's on the same two batches, the
  transform of each step replayed from JAX's per-step key: every stacked
  loss at rtol 1e-4; the dice counts of the first step within a pixel (a
  near-tie), of the second within 1% of the count (its weights are one
  update's f32 noise apart); the sum of the two updates at twice the
  one-step L2 bounds of tests/test_torch_step.py (6e-2 a tensor, 4e-2 over
  all: the errors of two updates add; the consistency gradient is a
  difference of nearly equal softmaxes); BN statistics at 1e-3 of the
  largest value.
- (b) The device-cached step at K = 2 against JAX's, its ``fold_in`` /
  ``split`` keys replayed into the indices, crops and transforms: the
  sampled scan ids equal, the rest as (a).
- (c) K = 2 against K = 1 from one seed over 4 steps, bit for bit: losses,
  parameters, BN statistics, optimizer and hook states, for ``semi``, ICT
  (its draws from the host generator) and self-paced InfoNCE across an
  epoch boundary (its age parameter reads the epoch); also
  ``accumulate_iter=2``.
- (d) The optimizer's device scalars (RAdam's ro, r and bias corrections,
  every schedule) against their host forms, bit for bit in f32, from t = 1
  past the rectification switch and across the warmup join.
- (e) The port's mirrors of tests/test_unrolled_trainer.py and of
  tests/test_device_cache.py's unrolled run, and JAX's warning when K does
  not divide ``num_batches``.
- (f) The refusals: ``adv`` and pretraining at K > 1; W > 1 ranks at K > 1
  no longer refused (a loop of K steps, no graph).
"""
import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data.device_cache import DeviceDataCache as JCache
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_cached_train_step as jbuild_cached
from contrastyou_tpu.engine.steps import build_unrolled_train_step as jbuild_unrolled
from contrastyou_tpu.engine.steps import stack_batches as jstack
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine import optim
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_cached_train_step,
                                                build_unrolled_train_step, init_train_state,
                                                stack_batches)
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.main import build_pretrain_run, build_semi_run, parse_config
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.parallel.mesh import DataGroup
from contrastyou_tpu_torch.utils.torch_convert import flax_to_state_dict, state_dict_to_flax
from torch_parity import close, n, scaled_close, t

torch.set_num_threads(1)

K, NL, NU, S, RAW = 2, 2, 2, 32, 40
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}
SMALL = dict(device="cpu", dtype=torch.float32, raw_size=RAW, crop=S, n_slices=8,
             max_channel=32)


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")
    monkeypatch.setenv("CONTRASTYOU_MXU_CROP", "0")


# --- (a), (b): against JAX ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_start():
    """JAX's bundle on the port's seeded weights (no flax init to compile),
    its consistency hook and optimizer, and the weights as numpy."""
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    flax = state_dict_to_flax(model.state_dict())
    start = (flax["params"], flax["batch_stats"])
    bundle = JBundle(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                     *jax.tree.map(jnp.asarray, start), (S, S, 1))
    hooks = [JConsistency(weight=10.0)]
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    return bundle, hooks, tx, start


def _jax_state(bundle, hooks, tx):
    return jinit(bundle, hooks, tx, jax.random.PRNGKey(1))


def _port_start(params, stats):
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    bundle = ModelBundle(model, (S, S, 1))
    hooks = [ConsistencyTrainerHook(weight=10.0)]
    opt, _ = create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75,
                              steps_per_epoch=200)
    return bundle, hooks, init_train_state(bundle, hooks, opt)


def _step_draws(key, nu):
    """The port's draws of the transform JAX's ``semi`` step draws from ``key``."""
    k_geo, k_int, _ = jax.random.split(key, 3)
    geo = sample_geo_params(k_geo, nu)
    gammas = jax.random.uniform(k_int, (nu, 1, 1, 1), minval=0.5, maxval=2.0)
    return StepDraws(GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                     t(gammas).reshape(nu))


def _l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


#: the update bounds of tests/test_torch_step.py for one step (per tensor,
#: over all), for the sum of K updates whose errors add
UPDATE_L2 = (K * 3e-2, K * 2e-2)


def _check_against_jax(state, jnew, jm, m, start, what):
    for k in ("sup_loss", "reg_loss", "total_loss", "consistency/loss"):
        assert m[k].shape == (K,), k
        close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=f"{what} {k}")
    for k in ("dice_inter", "dice_union"):
        assert m[k].shape == jm[k].shape, k
        diff = np.abs(n(m[k]) - jm[k])
        # the first step from the same weights: a pixel at a near-tie; the
        # second from weights one update's f32 noise apart: 1% of the count
        assert diff[0].max() <= 1 and (diff[1:] <= np.maximum(1, 0.01 * jm[k][1:])).all(), k
    assert state.step == K
    params, stats = start
    new = state_dict_to_flax(state.model.state_dict())
    upd = jax.tree.map(lambda a, b: a - b, new["params"], params)
    jupd = jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.params, params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(upd)[0], jax.tree.leaves(jupd)):
        assert _l2(a, b) <= UPDATE_L2[0], \
            f"{what} update {jax.tree_util.keystr(path)}: {_l2(a, b):.3e}"
    assert _l2(*(np.concatenate([np.ravel(v) for v in jax.tree.leaves(u)])
                 for u in (upd, jupd))) <= UPDATE_L2[1], what
    for a, b in zip(jax.tree.leaves(new["batch_stats"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, jnew.batch_stats))):
        scaled_close(a, b, tol=1e-3, what=f"{what} stats")


def test_unrolled_step_matches_jax(jax_start):
    rng = np.random.default_rng(0)
    batches = [{"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
                "labeled_target": rng.integers(0, 4, (NL, S, S)).astype(np.int32),
                "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}
               for _ in range(K)]
    rngs = jnp.stack([jax.random.PRNGKey(7 + i) for i in range(K)])
    jbundle, jhooks, tx, start = jax_start
    step = jbuild_unrolled(jbundle, tx, jhooks, unroll=K, two_stage=True, mode="semi")
    jnew, jm = step(_jax_state(jbundle, jhooks, tx), jstack([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
                    rngs, jnp.int32(0))
    jm = jax.tree.map(np.asarray, jm)

    bundle, hooks, state = _port_start(*start)
    unrolled = build_unrolled_train_step(bundle, hooks, unroll=K)
    m = unrolled(state, stack_batches([{k: torch.tensor(v) for k, v in b.items()}
                                       for b in batches]),
                 [_step_draws(rngs[i], NU) for i in range(K)])
    _check_against_jax(state, jnew, jm, m, start, "unrolled")
    assert m["lr"].shape == (K,) and [float(v) for v in m["lr"]] == [
        state.optimizer.schedule(i) for i in range(K)]


def _caches(seed=3):
    """Two splits of RAW x RAW slices, as JAX's and the port's caches."""
    rng = np.random.default_rng(seed)
    out = []
    for n_slices in (5, 6):
        images = rng.random((n_slices, RAW, RAW)).astype(np.float32)
        targets = rng.integers(0, 4, (n_slices, RAW, RAW))
        ids = {k: np.arange(n_slices) % m for k, m in (("scan_id", 3), ("partition", 3),
                                                       ("patient", 2), ("cycle", 2))}
        jcache = JCache(images, targets, scan_names=["a", "b", "c"], crop=S, **ids)
        cache = DeviceDataCache.from_arrays(images, targets, crop=S, device="cpu", **ids)
        out.append((jcache, cache))
    return out


def _replayed_cache_draws(key, n_lab, n_unl):
    """JAX's cached step's per-step keys (``fold_in(rng, i)``, ``split`` into
    the sample and step keys, the sample key into the two caches' keys, each
    into index and crop keys) replayed as the port's draws."""
    drawn = []
    for i in range(K):
        k_sample, k_step = jax.random.split(jax.random.fold_in(key, i))
        parts = {"draws": _step_draws(k_step, n_unl)}
        for name, k, b, n_slices in zip(("labeled", "unlabeled"), jax.random.split(k_sample),
                                        (n_lab, n_unl), (5, 6)):
            ki, ky, kx = jax.random.split(k, 3)
            parts[name] = tuple(torch.tensor(np.asarray(v), dtype=torch.long) for v in (
                jax.random.randint(ki, (b,), 0, n_slices),
                jax.random.randint(ky, (b,), 0, RAW - S + 1),
                jax.random.randint(kx, (b,), 0, RAW - S + 1)))
        drawn.append(parts)
    return drawn


def test_cached_unrolled_step_matches_jax(jax_start):
    (jlab, lab), (junl, unl) = _caches()
    key = jax.random.PRNGKey(11)
    jbundle, jhooks, tx, start = jax_start
    step = jbuild_cached(jbundle, tx, jhooks, labeled_cache=jlab, unlabeled_cache=junl,
                         labeled_batch=NL, unlabeled_batch=NU, unroll=K, two_stage=True)
    jnew, jm = step(_jax_state(jbundle, jhooks, tx), key, jnp.int32(0))
    jm = jax.tree.map(np.asarray, jm)

    bundle, hooks, state = _port_start(*start)
    cached = build_cached_train_step(bundle, hooks, labeled_cache=lab, unlabeled_cache=unl,
                                     labeled_batch=NL, unlabeled_batch=NU, unroll=K)
    m = cached.run(state, _replayed_cache_draws(key, NL, NU))
    assert m["labeled_scan_id"].shape == (K, NL)
    np.testing.assert_array_equal(m["labeled_scan_id"].numpy(), jm["labeled_scan_id"])
    _check_against_jax(state, jnew, jm, m, start, "cached")


# --- (c): K = 2 against K = 1, bit for bit -------------------------------------------------

#: ICT's section as config/hooks/ict.yaml writes it; self-paced InfoNCE with
#: an age parameter that moves between the two epochs
ICT = ["Trainer.name=mt", "~MeanTeacherParameters", "+ICTMeanTeacherParameters.weight=1",
       "+ICTMeanTeacherParameters.alpha=0.999", "+ICTMeanTeacherParameters.weight_decay=1e-5",
       "+ICTMeanTeacherParameters.mix_alpha=0.2"]
SELF_PACED = ["Trainer.name=semi", "Trainer.max_epoch=2", "+SPInfonceParams.feature_names=Conv5",
              "+SPInfonceParams.weights=1", "+SPInfonceParams.contrast_ons=partition",
              "+SPInfonceParams.begin_values=2", "+SPInfonceParams.end_values=20",
              "+SPInfonceParams.mode=soft", "+SPInfonceParams.p=0.5"]
CASES = {"semi": ["Trainer.name=semi"], "ict": ICT, "self_paced": SELF_PACED,
         "accumulate": ["Trainer.name=semi", "Trainer.accumulate_iter=2"]}


def _snapshot(run) -> dict:
    out = {f"model.{k}": v.detach().clone() for k, v in run.state.model.state_dict().items()}
    for i, st in enumerate(run.state.optimizer.state.values()):
        out.update({f"opt{i}.{k}": v.clone() for k, v in st.items()})
    for name, st in run.state.hook_states.items():
        for k, v in st.items():
            items = v.items() if isinstance(v, dict) else [("", v)]
            out.update({f"{name}.{k}.{j}": torch.as_tensor(x).clone() for j, x in items
                        if isinstance(x, (torch.Tensor, int))})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_unroll_two_equals_one_bitwise(case):
    """4 steps as 4 one-step calls and as 2 two-step calls from one seed; the
    self-paced case runs its calls in epochs 0, 0, 1, 1 (one and one)."""
    epochs = [0, 0, 1, 1]
    runs, losses = {}, {}
    for unroll in (1, K):
        run = build_semi_run(parse_config(["-o", *CASES[case],
                                           f"Trainer.unroll_steps={unroll}"]), **SMALL)
        got = []
        for i in range(0, 4, unroll):
            m = run.step(run.state, run.generator, epochs[i], run.host_rng)
            got += [m["total_loss"]] if unroll == 1 else list(m["total_loss"].unbind(0))
        runs[unroll], losses[unroll] = run, torch.stack(got)
    assert torch.equal(losses[1], losses[K]), (losses[1], losses[K])
    assert runs[1].state.step == runs[K].state.step == 4
    a, b = _snapshot(runs[1]), _snapshot(runs[K])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert runs[1].state.optimizer.count == runs[K].state.optimizer.count == (
        2 if case == "accumulate" else 4)


def test_step_updates_hook_states_in_place():
    """A hook whose ``loss`` returns a new state tensor (the cross-correlation
    block's dynamic ``imsat_weight``) has it written into the state's own
    tensor after the update, so the tensor a CUDA graph captured is the one
    later steps read; the step's metric keeps the weight the loss read."""
    cc = ["+CrossCorrelationParameters.feature_name=Up_conv2",
          "+CrossCorrelationParameters.num_clusters=10",
          "+CrossCorrelationParameters.hooks.imsat.weight=0.1",
          "+CrossCorrelationParameters.hooks.imsat.use_dynamic=true"]
    run = build_semi_run(parse_config(["-o", "Trainer.name=semi", *cc]), **SMALL)
    name = next(h.name for h in run.hooks if h.name.startswith("cc_"))
    weight = run.state.hook_states[name]["imsat_weight"]
    seen = []
    for _ in range(2):
        before = weight.clone()
        m = run.step(run.state, run.generator, 0, run.host_rng)
        assert run.state.hook_states[name]["imsat_weight"] is weight
        assert torch.equal(m[f"{name}/imsat_weight"], before) and not torch.equal(weight, before)
        seen.append(float(weight))
    assert seen[0] != seen[1]


# --- (d): the optimizer's device scalars --------------------------------------------------

def test_device_scalars_equal_the_host_forms():
    """RAdam's ro, r and bias corrections and every schedule, computed on
    the device from an int64 count, equal their host forms in f32, bit for
    bit: t = 1..40 (ro crosses 4 at t = 5 and the threshold 5 at t = 6),
    then far out; each schedule across its warmup join and milestones."""
    ts = [*range(1, 41), 100, 1000, 12345, 150000]
    for b1, b2 in ((0.9, 0.999), (0.5, 0.99)):
        got = optim._radam_tensors(b1, b2, torch.tensor(ts, dtype=torch.int64))
        for i, step in enumerate(ts):
            want = optim._radam_scalars(b1, b2, step)
            for name, g, w in zip(("ro", "r", "mu_scale", "nu_scale"), got, want):
                assert np.float32(g[i].item()) == np.float32(w), (b1, b2, step, name)
    kw = dict(base_lr=1e-4, multiplier=300, warmup_max_epoch=2, max_epoch=7, steps_per_epoch=10)
    schedules = [optim.warmup_schedule(**kw), optim.warmup_schedule(**kw, name="poly"),
                 optim.warmup_schedule(**kw, name="step", milestones=[0, 1, 3, 5, 5],
                                       gamma=0.5),
                 optim.ConstantSchedule(3e-4)]
    counts = [*range(0, 75), 80, 1000]
    for sched in schedules:
        got = sched.tensor(torch.tensor(counts, dtype=torch.int64))
        assert got.dtype == torch.float64
        for c, g in zip(counts, got.tolist()):
            assert np.float32(g) == np.float32(sched(c)), (getattr(sched, "name", "const"), c)


def test_optimizer_reads_nothing_back_per_update():
    """``count`` and ``mini_step`` live on the parameters' device and are
    read as ints; ``state_dict`` writes them as ints, and a dict holding
    them loads into a fresh optimizer that then steps as the first."""
    ps = [torch.nn.Parameter(torch.linspace(-1, 1, 6).reshape(2, 3))]
    opt, _ = create_optimizer(ps, OPTIM, SCHED, max_epoch=2, steps_per_epoch=3,
                              accumulate_iter=2)
    for k in range(3):
        ps[0].grad = torch.full_like(ps[0], 0.5 - k)
        opt.step()
    assert isinstance(opt._counters["count"], torch.Tensor)
    sd = opt.state_dict()
    assert (sd["count"], sd["mini_step"]) == (1, 1) and type(sd["count"]) is int
    twin_ps = [torch.nn.Parameter(ps[0].detach().clone())]
    twin, _ = create_optimizer(twin_ps, OPTIM, SCHED, max_epoch=2, steps_per_epoch=3,
                               accumulate_iter=2)
    twin.load_state_dict(copy.deepcopy(sd))
    for p in (ps[0], twin_ps[0]):
        p.grad = torch.full_like(p, 0.25)
    opt.step()
    twin.step()
    assert torch.equal(ps[0], twin_ps[0]) and opt.count == twin.count == 2


# --- (e), (f): the loop and the refusals ---------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=4, num_val_scans=2, slices_per_scan=4, size=48)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def _argv(save_dir, *extra):
    return ["-o", "Trainer.name=semi", "Arch.max_channel=32", f"Trainer.save_dir={save_dir}",
            "Data.labeled_scan_num=2", "LabeledLoader.batch_size=3",
            "UnlabeledLoader.batch_size=3", "Trainer.device=cpu", "Trainer.unroll_steps=2",
            *extra]


def test_semi_trainer_unrolled(paths):
    """tests/test_unrolled_trainer.py on the port: host-fed, 4 steps as 2
    calls of 2; finite storage with the hook's column, ``step`` 4."""
    assert port_main.main(_argv("host", "Trainer.max_epoch=1", "Trainer.num_batches=4")) == 0
    header, row = (paths / "host" / "storage.csv").read_text().splitlines()
    values = dict(zip(header.split(","), row.split(",")))
    assert any("consistency" in k for k in values)
    assert np.isfinite(float(next(v for k, v in values.items() if "sup_loss" in k)))
    saved = load_checkpoint(paths / "host" / "last")["train_state"]
    assert saved["step"] == saved["optimizer_count"] == 4


def test_cached_trainer_unrolled_warns_on_a_ragged_epoch(paths, caplog):
    """tests/test_device_cache.py's unrolled run on the port (the device
    cache, 2 epochs, K = 2), at ``num_batches`` 5: JAX's warning, 2 calls of
    2 steps an epoch, the files written."""
    with caplog.at_level(logging.WARNING, logger="contrastyou_tpu_torch.engine.trainer"):
        assert port_main.main(_argv("cached", "Trainer.max_epoch=2", "Trainer.num_batches=5",
                                    "Trainer.device_cache=true")) == 0
    assert ("num_batches=5 not divisible by unroll_steps=2; running 4 steps per epoch"
            in caplog.text)
    run = paths / "cached"
    assert (run / "storage.csv").exists() and (run / "last").exists() and (run / ".success").exists()
    assert len((run / "storage.csv").read_text().splitlines()) == 3
    assert load_checkpoint(run / "last")["train_state"]["step"] == 8


@pytest.mark.parametrize("name", ["adv", "pretrain", "pretrain_decoder"])
def test_trainers_with_their_own_loop_refuse_unroll(paths, name):
    """JAX's adversarial and pretraining trainers run one step a call
    whatever K is: the port's raise at construction, and so does
    ``build_pretrain_run``."""
    extra = [] if name == "adv" else ["ContrastiveLoaderParams.scan_sample_num=2"]
    with pytest.raises(NotImplementedError, match="one step a call"):
        port_main.main(_argv(f"refused_{name}", f"Trainer.name={name}", "Trainer.max_epoch=1",
                             "Trainer.num_batches=2", *extra))
    cfg = parse_config(["-o", f"Trainer.name={name}", "Trainer.unroll_steps=2"])
    if name != "adv":
        with pytest.raises(NotImplementedError, match="one step a call"):
            build_pretrain_run(cfg, device="cpu", dtype=torch.float32, raw_size=36, crop=32,
                               n_scans=6, max_channel=32)


def test_ranks_refuse_unroll(tmp_path):
    """W > 1 ranks and K > 1: the builders and the ``semi`` trainer no
    longer refuse; on ranks the K steps of a call run as a loop, never as a
    CUDA graph (the ranks' collectives are host round trips), and the
    trainers with a loop of their own refuse K as in one process
    (tests/test_torch_parallel_unroll.py runs the steps on two ranks)."""
    group = DataGroup(rank=0, size=2, device=torch.device("cpu"), process_group=None)
    run = build_semi_run(parse_config(["-o", "Trainer.name=semi"]), **SMALL)
    bundle = ModelBundle(run.state.model, (S, S, 1))
    cached = build_cached_train_step(bundle, run.hooks, labeled_cache=run.labeled_cache,
                                     unlabeled_cache=run.unlabeled_cache, data_group=group,
                                     unroll=2)
    unrolled = build_unrolled_train_step(bundle, run.hooks, data_group=group, unroll=2)
    assert not cached.graph.capture and not unrolled.graph.capture
    assert build_unrolled_train_step(bundle, run.hooks, unroll=2).graph.capture
    from contrastyou_tpu_torch.trainers.adv import AdversarialTrainer
    from contrastyou_tpu_torch.trainers.semi import SemiTrainer
    SemiTrainer(model=run.state.model, labeled_loader=None, save_dir=str(tmp_path / "run"),
                data_group=group, unroll_steps=2)
    with pytest.raises(NotImplementedError, match="one step a call"):
        AdversarialTrainer(model=run.state.model, labeled_loader=None,
                           save_dir=str(tmp_path / "adv"), unroll_steps=2)
