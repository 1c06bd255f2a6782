"""The hooks and trainers of the PyTorch port beyond consistency and the
encoder InfoNCE hook on W > 1 ranks (engine/steps.py ``shard_step_draws``,
hooks/{entmin,pseudolabel,orthogonal,autoencoder,mt,discretemi,midl,
infonce}.py, losses/discrete_mi.py), on the CPU: two gloo ranks on
127.0.0.1, spawned once for the module (tests/torch_dp.py ``hooks_worker``
runs every configuration of ``HOOK_CONFIGS`` in turn), each holding half
of a global batch of 4 + 4 slices of 32 x 32 drawn from a seeded numpy
generator, against one process on the whole batch with the same weights
and draws. The U-Net at max_channel 64 in f32, the kernels' plain versions,
RAdam at lr 1e-3; two steps a configuration (UAMT at epoch 1 of 4, the
self-paced pair at epoch 2 of 10).

Tolerances, tests/test_torch_parallel.py's, each with a floor for
the values these hooks take near zero or far from one:

- every step's losses and metrics rel 1e-5, or abs 5e-7: the mutual
  information losses start near -2e-4, the difference of entropies of
  order ln 5 = 1.6, whose f32 rounding (1.9e-7 an ulp) the order of the
  global sums moves (measured 1.0e-7 at most);
- parameters, BN running statistics and the hooks' states (the teachers,
  the EMA) atol 2e-5; the dense InfoNCE heads' biases
  (``DENSE_HEAD_BIASES``) atol 2e-5 plus 1e-5 of the tensor's largest
  value: they reach 1e8 in two steps (a fifth of the aligned first view
  lies outside the warped image, where the features are zero and the L2
  normalization's gradient is 1/eps; the reference arithmetic, JAX's too),
  where an f32 ulp is 8 (measured 1.3e-6 of the largest);
- the first step's gradients, before the update, per tensor within 2e-3 in
  L2 of the larger of the tensor's norm and 1e-3 of the whole gradient's,
  all together within 1e-3 (the order of the global sums alone moves them;
  an IIC head's gradient at the near-zero start is 1e-5, a cancelling sum
  of order-1 terms: measured 5.2e-3 of its own norm, 5.5e-8 absolute);
- dice counts equal.

The ranks end bitwise equal. UAMT's noise on
a rank is its rows of the one-process noise (cut along axis 1), ICT's
``lam`` and permutation are the one-process draws, and the mixed images of
a rank's student forward are its rows of the one-process mixed batch,
bitwise.
"""
import numpy as np
import pytest
import torch

from contrastyou_tpu_torch.engine.steps import StepDraws, shard_step_draws
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.mt import ICTMeanTeacherTrainerHook, UAMeanTeacherTrainerHook
from contrastyou_tpu_torch.main import build_semi_run, parse_config
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.parallel import DataGroup, all_reduce_sum, num_ranks
from contrastyou_tpu_torch.trainers import trainer_zoo
from torch_dp import HOOK_CONFIGS, hooks_worker, run_hook_steps, spawn

B, S, MC, W = 4, 32, 64, 2
NAMES = sorted(HOOK_CONFIGS)
#: the dense heads' biases that reach 1e8 (the docstring's tolerances)
DENSE_HEAD_BIASES = {f"{h}/projector.Conv_{i}.bias"
                     for h in ("dense_nce", "spnce_dense", "spixel") for i in (0, 1)}


def batch(b: int = B, size: int = S) -> dict:
    """A global batch from a seeded numpy generator; the superpixel map of
    blocks of 8 x 8 pixels of 6 ids."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 6, (b, size // 8, size // 8))
    np_batch = {"labeled_image": rng.random((b, size, size, 1)).astype(np.float32),
                "labeled_target": rng.integers(0, 4, (b, size, size)),
                "unlabeled_image": rng.random((b, size, size, 1)).astype(np.float32),
                "unlabeled_partition": rng.integers(0, 3, (b,)),
                "unlabeled_scan_id": rng.integers(0, 4, (b,)),
                "unlabeled_patient": rng.integers(0, 2, (b,)),
                "unlabeled_cycle": np.zeros((b,), np.int64),
                "unlabeled_superpixel": np.kron(blocks, np.ones((8, 8), np.int64))}
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long()
            for k, v in np_batch.items()}


@pytest.fixture(scope="module")
def job():
    return {"max_channel": MC, "size": S, "seed": 4, "batch": batch(), "configs": NAMES}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_hooks")
    torch.save(job, d / "job.pt")
    spawn(hooks_worker, W, str(d / "job.pt"), str(d))
    return [torch.load(d / f"rank{r}.pt") for r in range(W)]


@pytest.fixture(scope="module")
def one_process(job):
    torch.set_num_threads(1)
    return {name: run_hook_steps(job, name) for name in NAMES}


def l2(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def check_against_one_process(got: dict, ref: dict, what: str) -> None:
    """The tolerances of the module docstring."""
    assert len(got["metrics"]) == len(ref["metrics"])
    for i, (m, mr) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(m) == set(mr), what
        for k, v in mr.items():
            if k.startswith("dice"):
                assert torch.equal(m[k], v), f"{what} step {i} {k}"
            else:
                assert float(m[k]) == pytest.approx(float(v), rel=1e-5, abs=5e-7), \
                    f"{what} step {i} {k}: {float(m[k])} vs {float(v)}"
    for key in ("params", "buffers", "hook_states"):
        assert set(got[key]) == set(ref[key]), (what, key)
        for name, v in ref[key].items():
            err = float((got[key][name].float() - v.float()).abs().max())
            scale = float(v.float().abs().max()) if name in DENSE_HEAD_BIASES else 0.0
            assert err <= 2e-5 + 1e-5 * scale, f"{what} {key} {name}: {err:.2e} of {scale:.2e}"
    flat = [torch.cat([d[k].reshape(-1) for k in ref["grads"]])
            for d in (got["grads"], ref["grads"])]
    assert l2(*flat) <= 1e-3, f"{what} gradients: {l2(*flat):.2e}"
    floor = 1e-3 * float(flat[1].norm())
    for name, g in ref["grads"].items():
        err = float((got["grads"][name] - g).norm())
        assert err <= 2e-3 * max(float(g.norm()), floor), \
            f"{what} grad {name}: {err:.2e} of {float(g.norm()):.2e}"


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_one_process(ranks, one_process, name):
    """Configuration ``name`` on two ranks computes the one process's global
    batch: losses, metrics, gradients, parameters, BN statistics and the
    hooks' states; both ranks end bitwise equal, teachers included."""
    for key in ("params", "buffers", "hook_states", "grads"):
        for k, v in ranks[0][name][key].items():
            assert torch.equal(v, ranks[1][name][key][k]), f"ranks differ: {key} {k}"
    check_against_one_process(ranks[0][name], one_process[name], name)


def test_uamt_noise_is_the_ranks_rows(ranks, one_process):
    """UAMT's noise [num_noise, B, H, W, 1] is drawn at the global batch and
    each rank keeps its rows of every pass (axis 1), not num_noise/W whole
    passes."""
    full = one_process["uamt"]["seen"]["draw"]
    assert full.shape == (2, B, S, S, 1)
    per = B // W
    for r, res in enumerate(ranks):
        assert torch.equal(res["uamt"]["seen"]["draw"], full[:, r * per:(r + 1) * per]), r


def test_ict_draws_are_whole_and_mix_the_ranks_rows(ranks, one_process):
    """ICT's ``lam`` and permutation of the global batch's 2B images are the
    one-process draws on every rank, and a rank's student forward runs on
    its rows (its first views, then its second views) of the one-process
    mixed batch, which takes rows of the other rank."""
    ref = one_process["ict"]["seen"]
    lam, perm = ref["draw"]
    perm = perm.tolist()
    assert sorted(perm) == list(range(2 * B))
    per = B // W
    for r, res in enumerate(ranks):
        rlam, rperm = res["ict"]["seen"]["draw"]
        assert torch.equal(rlam, lam) and rperm.tolist() == perm
        rows = [*range(r * per, (r + 1) * per), *range(B + r * per, B + (r + 1) * per)]
        assert torch.equal(res["ict"]["seen"]["student_input"], ref["student_input"][rows]), r
    own = [{*range(r * per, (r + 1) * per), *range(B + r * per, B + (r + 1) * per)}
           for r in range(W)]
    assert any(perm[i] not in own[r] for r in range(W) for i in own[r])


def test_self_paced_weights_span_the_global_pairs(ranks, one_process):
    """The self-paced hooks gather the anchors, so the pair weights, their
    mean (``sp_weight``) and ``correct_grad``'s divisor are the global
    batch's with no change to the loss: each rank's metric is the one
    process's value (not a mean of per-rank means), and so are the heads'
    gradients."""
    ref = one_process["spnce"]
    for name in ("spnce", "spnce_dense"):
        want = float(ref["metrics"][0][f"{name}/sp_weight"])
        assert 0.0 < want <= 1.0
        for res in ranks:
            got = float(res["spnce"]["metrics"][0][f"{name}/sp_weight"])
            assert got == pytest.approx(want, rel=1e-6), name
        for k, g in ref["grads"].items():
            if k.startswith(f"{name}/"):
                assert l2(ranks[0]["spnce"]["grads"][k], g) <= 2e-3, k


def test_shard_step_draws_cuts_each_hook_on_its_own_axis():
    """Geometry, gammas and the point draws are cut by rows; UAMT's noise on
    axis 1; ICT's draws stay whole; other hooks' draws on axis 0."""
    gen = torch.Generator().manual_seed(0)
    geo = GeoParams(*(torch.rand(6, generator=gen) for _ in GeoParams._fields))
    uamt, ict = UAMeanTeacherTrainerHook(num_noise=3), ICTMeanTeacherTrainerHook()
    other = ConsistencyTrainerHook(name="other")
    noise = torch.randn(3, 6, 4, 4, 1, generator=gen)
    points = {(8, 8): (torch.arange(30).reshape(6, 5), torch.arange(30).reshape(6, 5) + 1)}
    draws = StepDraws(geo, torch.arange(6.0), {"uamt": noise, "ict": (0.25, tuple(range(12))),
                                               "other": torch.arange(6)}, points)
    group = DataGroup(1, 3, torch.device("cpu"))
    got = shard_step_draws(draws, [uamt, ict, other], group)
    assert torch.equal(got.hooks["uamt"], noise[:, 2:4])
    assert got.hooks["ict"] == (0.25, tuple(range(12)))
    assert torch.equal(got.hooks["other"], torch.tensor([2, 3]))
    assert torch.equal(got.gammas, torch.tensor([2.0, 3.0]))
    assert all(torch.equal(a, b[2:4]) for a, b in zip(got.geo, geo))
    assert torch.equal(got.points[(8, 8)][0], points[(8, 8)][0][2:4])
    assert shard_step_draws(draws, [uamt], None) is draws
    assert shard_step_draws(None, [uamt], group) is None


def test_batch_sums_without_a_group_run_no_collective():
    """Without a group of W > 1 ranks ``all_reduce_sum`` is its input and W
    is 1, so UAMT's masked ratio and the IIC and IMSAT sums take one code
    path in one process and over ranks."""
    x = torch.arange(6.0)
    assert all_reduce_sum(x, None) is x
    assert all_reduce_sum(x, DataGroup(0, 1, torch.device("cpu"))) is x
    assert num_ranks(None) == 1 and num_ranks(DataGroup(1, 3, torch.device("cpu"))) == 3


@pytest.mark.parametrize("name", ["semi", "ft", "mt", "mixup", "adv"])
def test_semi_run_takes_the_trainers_hooks_and_mode(name):
    """``build_semi_run`` runs the hooks and the step of the ``Trainer.name``
    trainer (``Trainer.active_hooks``, ``train_mode``), as the trainer
    does: ``ft`` and ``adv`` keep only the EMA eval model of the hooks,
    ``ft`` and ``mixup`` step on the labeled batch alone."""
    config = parse_config(["-o", f"Trainer.name={name}", "+EvalEMAParameters.alpha=0.9",
                           "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2"])
    run = build_semi_run(config, device="cpu", dtype=torch.float32, raw_size=40, crop=32,
                         n_slices=8, max_channel=32)
    cls = trainer_zoo[name]
    names = [h.name for h in run.hooks]
    assert "ema_eval" in names
    assert (names == ["ema_eval"]) == (not cls.activate_hooks), names
    assert run.batch_slices == (2 if cls.train_mode == "ft" else 4)
    assert np.isfinite(float(run.run(1)[0]["total_loss"]))
