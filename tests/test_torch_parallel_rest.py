"""The cross-correlation block, MixUp, multicore, DMT and the pretrain step
of the PyTorch port on W > 1 ranks (hooks/{ccblock,mixup,dmt}.py,
trainers/{multicore,pretrain}.py, engine/steps.py ``shard_draw``,
parallel/collectives.py), on the CPU: two gloo ranks on 127.0.0.1, spawned
once for the module (tests/torch_dp.py ``hooks_worker`` runs every
configuration of ``REST_CONFIGS`` in turn, then the second-order checks),
each holding half of a global batch of 4 + 4 slices of 32 x 32 drawn from
a seeded numpy generator, against one process on the whole batch with the
same weights and draws. The U-Net at max_channel 64 in f32, the kernels'
plain versions, RAdam at lr 1e-3; two steps a configuration: the block on
Up_conv2 (cc, mi, rr, imsat; 5 clusters, 2 subheads) and on Deconv_1x1
(the same and consist), MixUp under the ``ft`` step, multicore (2
prototypes a class, ``MultiCoreKL``) with the IIC segmentation hook and
with the mean teacher beside it, DMT under each of its six update rules
(epoch 1), and the pretrain step with the encoder InfoNCE hook (Conv5 by
partition) and with ``pretrain_cc``'s hooks (that, and the block on
Up_conv2 with cc and rr).

Tolerances: tests/test_torch_parallel_hooks.py's (the step's losses and
metrics rel 1e-5 or abs 5e-7; parameters, BN statistics and hook states
atol 2e-5; the first step's gradients per tensor 2e-3 and together 1e-3
in L2), each widened by twice what reordering the rows of the global batch
moves the same value in one process (``REORDER``: the batch and the draws
taken in reverse, the same math summed in another order). In f32 that
floor alone exceeds those tolerances here: the first step's gradients
under DMT's consistency move 2.4e-3 together, and Adam's teacher
(``ADAM_TREES``, held in L2 as one vector each, 1e-3 plus twice the
reordering's) moves by up to 2 lr where the meta gradient's sign turns
(measured: the teacher 4.5e-3 in L2 from the one process after two steps,
its first moment 0.29, the reordered run 4.6e-3 and 0.29). MixUp, whose
permutation is not reordered, is held to the plain tolerances. The ranks end bitwise equal (the DMT teacher, its
statistics and ``teacher_opt``, ``imsat_weight``).

Second order: the Hessian-vector product through a BatchNorm with global
sums and through a loss of gathered rows, f64, on two ranks equals one
process's at the global batch to 1e-6 (``collective_hvp``; measured
7e-16), and DMT ``second_order``'s meta gradient and its Hessian-vector
part on two ranks are one process's within 2e-3 in L2 (measured 6e-5).
"""
import pytest
import torch

from contrastyou_tpu_torch.engine.steps import StepDraws, shard_draw, shard_step_draws
from contrastyou_tpu_torch.hooks.mixup import MixUpTrainHook
from contrastyou_tpu_torch.hooks.mt import ICTMeanTeacherTrainerHook
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.parallel import DataGroup, shard_batch
from contrastyou_tpu_torch.trainers.pretrain import sample_pretrain_draws
from test_torch_parallel_hooks import batch, l2
from contrastyou_tpu_torch.main import build_semi_run, parse_config
from torch_dp import (HVP_CASES, REST_CONFIGS, collective_hvp, dmt_hessian_term, hooks_worker,
                      hvp_inputs, pretrain_run_steps, run_hook_steps, spawn)

B, S, MC, W = 4, 32, 64, 2
NAMES = sorted(REST_CONFIGS)
#: the rows of the reordered one-process run
REORDER = torch.arange(B - 1, -1, -1)
#: configurations whose draws cannot be reordered by rows
NOT_REORDERED = {"mixup"}
#: the hook states moved by DMT's Adam teacher (``method1``, ``method3``;
#: the moments also ``method4``'s), compared each as one vector in L2:
#: Adam's update is ±lr wherever the meta gradient's sign turns, so which
#: elements move that far is f32 noise (the ranks and the reordered run each
#: move 8% of the teacher's elements by more than lr / 2 from the one
#: process after two steps, measured)
ADAM_TREES = ("dmt/teacher_params/", "dmt/teacher_opt/mu/", "dmt/teacher_opt/nu/")


#: ``build_pretrain_run``'s overrides: ``pretrain_cc``'s hooks, ACDC's
#: contrastive batch of 18 slices cut over the ranks
PRETRAIN_RUN = ["Trainer.name=pretrain_decoder", "InfonceParams.feature_names=Conv5",
                "InfonceParams.weights=1.0", "InfonceParams.contrast_ons=partition",
                "InfonceParams.spatial_size=1", "+CrossCorrelationParameters.feature_name=Up_conv2",
                "+CrossCorrelationParameters.num_clusters=5",
                "+CrossCorrelationParameters.hooks.rr.weight=1",
                "+CrossCorrelationParameters.hooks.rr.alpha=0.5"]


@pytest.fixture(scope="module")
def job():
    return {"max_channel": MC, "size": S, "seed": 4, "batch": batch(), "configs": NAMES,
            "hv": hvp_inputs(), "pretrain_run": PRETRAIN_RUN}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_rest")
    torch.save(job, d / "job.pt")
    spawn(hooks_worker, W, str(d / "job.pt"), str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]


@pytest.fixture(scope="module")
def one_process(job):
    torch.set_num_threads(1)
    return {name: run_hook_steps(job, name) for name in NAMES}


@pytest.fixture(scope="module")
def reordered(job):
    torch.set_num_threads(1)
    return {name: run_hook_steps(dict(job, order=REORDER), name) for name in NAMES
            if name not in NOT_REORDERED}


def _errors(got: dict, ref: dict) -> dict:
    """Each compared value's error against ``ref``: the metrics' relative
    error (abs below 5e-7 counted as 0), the tensors' largest absolute
    difference, the first step's gradients' L2 ratio (per tensor against
    the larger of its norm and 1e-3 of the whole gradient's, and all
    together)."""
    out = {}
    for i, (m, mr) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(m) == set(mr)
        for k, v in mr.items():
            if not k.startswith("dice"):
                d = abs(float(m[k]) - float(v))
                out[f"metric {i} {k}"] = 0.0 if d <= 5e-7 else d / max(abs(float(v)), 1e-30)
    for key in ("params", "buffers", "hook_states"):
        assert set(got[key]) == set(ref[key]), key
        for k, v in ref[key].items():
            if not k.startswith(ADAM_TREES):
                out[f"{key} {k}"] = float((got[key][k].float() - v.float()).abs().max())
    for tree in ADAM_TREES:
        keys = sorted(k for k in ref["hook_states"] if k.startswith(tree))
        if keys:
            out[f"tree {tree}"] = l2(*(torch.cat([d["hook_states"][k].reshape(-1).float()
                                                   for k in keys]) for d in (got, ref)))
    flat = [torch.cat([d[k].reshape(-1) for k in ref["grads"]]) for d in (got["grads"], ref["grads"])]
    out["grads"] = l2(*flat)
    floor = 1e-3 * float(flat[1].norm())
    for k, g in ref["grads"].items():
        out[f"grad {k}"] = float((got["grads"][k] - g).norm()) / max(float(g.norm()), floor)
    return out


def _tolerance(key: str) -> float:
    if key.startswith("metric"):
        return 1e-5
    if key == "grads" or key.startswith("tree "):
        return 1e-3
    return 2e-3 if key.startswith("grad ") else 2e-5


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_one_process(ranks, one_process, reordered, name):
    """Configuration ``name`` on two ranks computes the one process's global
    batch (the docstring's tolerances): losses, metrics, gradients,
    parameters, BN statistics and the hooks' states; both ranks end bitwise
    equal, the DMT teacher and its optimizer state and the block's
    ``imsat_weight`` included."""
    for key in ("params", "buffers", "hook_states", "grads"):
        for k, v in ranks[0][name][key].items():
            assert torch.equal(v, ranks[1][name][key][k]), f"ranks differ: {key} {k}"
    ref = one_process[name]
    for i, m in enumerate(ref["metrics"]):
        for k in ("dice_inter", "dice_union"):
            if k in m:
                assert torch.equal(ranks[0][name]["metrics"][i][k], m[k]), (i, k)
    got = _errors(ranks[0][name], ref)
    floor = _errors(reordered[name], ref) if name in reordered else dict.fromkeys(got, 0.0)
    bad = {k: (v, floor[k]) for k, v in got.items() if v > _tolerance(k) + 2.0 * floor[k]}
    assert not bad, f"{name}: (error, reordering's) {dict(list(bad.items())[:5])}"


def test_block_states_and_metrics_are_global(ranks, one_process):
    """The block's ``imsat_weight`` moves by the global marginal on both
    ranks, and its mi, rr and imsat metrics are the global batch's, not a
    mean of per-rank values (their joints and marginal span the ranks)."""
    for name, hook in (("cc_tap", "cc_Up_conv2"), ("cc_logits", "cc_Deconv_1x1")):
        ref = one_process[name]
        w0 = float(ref["metrics"][0][f"{hook}/imsat_weight"])
        w = [float(r[name]["hook_states"][f"{hook}/imsat_weight"]) for r in ranks]
        assert w[0] == w[1] and w[0] != w0
        assert w[0] == pytest.approx(float(ref["hook_states"][f"{hook}/imsat_weight"]),
                                     abs=1e-7)
        for k in ("mi", "rr", "imsat"):
            got = float(ranks[0][name]["metrics"][0][f"{hook}/{k}"])
            assert got == pytest.approx(float(ref["metrics"][0][f"{hook}/{k}"]), rel=1e-5,
                                        abs=5e-7), (name, k)


def test_mixup_draws_are_cut_by_part_and_mix_the_ranks_rows(ranks, one_process):
    """MixUp's GeoParams are each rank's rows of the global draw, ``lam`` and
    the permutation of the 2B global images the one-process draws, and a
    rank's mixed forward runs on its rows (its first views, then its
    second views) of the one-process mixed batch, bitwise."""
    ref = one_process["mixup"]["seen"]
    geo, lam, perm = ref["draw"]
    perm = perm.tolist()
    assert sorted(perm) == list(range(2 * B))
    per = B // W
    for r, res in enumerate(ranks):
        rgeo, rlam, rperm = res["mixup"]["seen"]["draw"]
        assert torch.equal(rlam, lam) and rperm.tolist() == perm
        assert all(torch.equal(a, b[r * per:(r + 1) * per]) for a, b in zip(rgeo, geo))
        rows = [*range(r * per, (r + 1) * per), *range(B + r * per, B + (r + 1) * per)]
        assert torch.equal(res["mixup"]["seen"]["student_input"], ref["student_input"][rows]), r
    own = [{*range(r * per, (r + 1) * per), *range(B + r * per, B + (r + 1) * per)}
           for r in range(W)]
    assert any(perm[i] not in own[r] for r in range(W) for i in own[r])


def test_dmt_teachers_optimizer_state_counts_the_global_steps(ranks, one_process):
    """The Adam teachers' update count is the one process's, the same on
    both ranks, and their moments are there on every rank."""
    for method in ("method1", "method3", "method4"):
        name = f"dmt_{method}"
        ref = one_process[name]["hook_states"]
        for res in ranks:
            got = res[name]["hook_states"]
            assert int(got["dmt/teacher_opt/count"]) == int(ref["dmt/teacher_opt/count"]) == 2
            assert {k for k in got if k.startswith("dmt/teacher_opt/")} == \
                {k for k in ref if k.startswith("dmt/teacher_opt/")}


@pytest.mark.parametrize("case", HVP_CASES)
def test_double_backward_through_the_collectives_matches_one_process(ranks, job, case):
    """H v of a loss through a BatchNorm with global sums (``all_reduce_sum``)
    and of a loss of gathered rows (``gather_rows``), the gradient taken
    with ``create_graph`` on each rank and summed over both: one process's
    at the global batch, in f64. A backward that the graph does not record
    drops the cross-rank part of the second-order term."""
    want = collective_hvp(job["hv"], case)
    for res in ranks:
        for got, ref in zip(res["hv"][case], want):
            assert l2(got, ref) <= 1e-6, case


def test_dmt_second_order_hessian_term_matches_one_process(ranks, job):
    """DMT ``second_order``'s meta gradient at its virtual teacher, and its
    Hessian-vector part (through the inner gradient, summed over the ranks
    by the differentiable all-reduce), on two ranks: one process's."""
    torch.set_num_threads(1)
    want = dmt_hessian_term(job)
    for part in ("whole", "hessian"):
        flat = [torch.cat([d[part][k].reshape(-1) for k in want[part]])
                for d in (ranks[0]["hv"]["dmt"], want)]
        assert float(flat[1].norm()) > 0.1, part
        assert l2(*flat) <= 2e-3, (part, l2(*flat))


def test_shard_draw_cuts_each_part_on_its_own_axis():
    """A hook's draw is cut by its ``draw_batch_dim``: MixUp's ``(geo, lam,
    perm)`` by rows, whole and whole; ICT's kept whole; a part count other
    than the rule's raises. The pretrain draws are cut by rows throughout."""
    gen = torch.Generator().manual_seed(0)
    geo = GeoParams(*(torch.rand(6, generator=gen) for _ in GeoParams._fields))
    mixup, ict = MixUpTrainHook(), ICTMeanTeacherTrainerHook()
    group = DataGroup(1, 3, torch.device("cpu"))
    perm = tuple(range(12))
    draws = StepDraws(geo, torch.arange(6.0), {"mixup": (geo, 0.3, perm), "ict": (0.25, perm)})
    got = shard_step_draws(draws, [mixup, ict], group)
    g, lam, p = got.hooks["mixup"]
    assert all(torch.equal(a, b[2:4]) for a, b in zip(g, geo)) and (lam, p) == (0.3, perm)
    assert got.hooks["ict"] == (0.25, perm)
    with pytest.raises(ValueError, match="axes"):
        shard_draw((geo, 0.3), mixup.draw_batch_dim, group)
    pre = sample_pretrain_draws(gen, 6, color_jitter=0.5, point_grids=[(8, 8)])
    cut = shard_batch(pre, group)
    assert torch.equal(cut.gammas_int, pre.gammas_int[2:4])
    assert torch.equal(cut.jitter2[1], pre.jitter2[1][2:4])
    assert torch.equal(cut.points[(8, 8)][0], pre.points[(8, 8)][0][2:4])
    assert all(torch.equal(a, b[2:4]) for a, b in zip(cut.g1, pre.g1))


def test_pretrain_run_cuts_the_contrastive_batch_over_the_ranks(ranks):
    """``build_pretrain_run(data_group=)``: every rank samples the
    one-process contrastive batch and its draws and keeps its half, so two
    steps on two ranks are one process's (the tolerances of
    ``test_two_ranks_match_one_process``) and the ranks end bitwise equal."""
    torch.set_num_threads(1)
    want = pretrain_run_steps(PRETRAIN_RUN)
    assert want["batch_slices"] == ranks[0]["pretrain_run"]["batch_slices"] == 18
    for k, p in ranks[0]["pretrain_run"]["params"].items():
        assert torch.equal(p, ranks[1]["pretrain_run"]["params"][k]), k
        assert float((p - want["params"][k]).abs().max()) <= 2e-5, k
    for m, mw in zip(ranks[0]["pretrain_run"]["metrics"], want["metrics"]):
        assert set(m) == set(mw)
        for k, v in mw.items():
            assert float(m[k]) == pytest.approx(float(v), rel=1e-5, abs=5e-7), k


def test_semi_run_builds_multicores_prototypes_and_criterion():
    """``build_semi_run`` with ``Trainer.name=multicore``: the model predicts
    ``multiplier`` prototype channels a class, the step takes
    ``MultiCoreKL`` and counts dice over the 4 true classes."""
    torch.set_num_threads(1)
    config = parse_config(["-o", "Trainer.name=multicore", "LabeledLoader.batch_size=2",
                           "UnlabeledLoader.batch_size=2"])
    run = build_semi_run(config, device="cpu", dtype=torch.float32, raw_size=40, crop=32,
                         n_slices=8, max_channel=32)
    multiplier = int(config["MulticoreParameters"]["multiplier"])
    assert run.state.model.num_classes == 4 * multiplier > 4
    m = run.run(1)[0]
    assert m["dice_inter"].shape == (2, 4)
    assert torch.isfinite(m["total_loss"])
