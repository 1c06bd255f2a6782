"""K train steps a call on W > 1 ranks in the port (``Trainer.unroll_steps``
with a ``data_group``; engine/steps.py ``build_unrolled_train_step``,
``build_cached_train_step(unroll=)``, engine/trainer.py), on two gloo CPU
ranks (tests/torch_dp.py ``unroll_worker``, one spawn for the module).
The six trainers that take K on ranks (``semi``, ``ft``, ``mt``,
``mixup``, ``multicore``, ``dmt``; ``semi`` also host-fed) at the small
size of tests/test_torch_unroll.py (max_channel 32, 32 x 32, f32), 2
slices a rank, 4 steps:

- K = 2 against K = 1 on the same ranks, bit for bit: every step's loss and
  every state tensor (parameters, BN statistics, optimizer moments, hook
  states), the ranks equal to each other; no graph replayed (on ranks the
  K steps are a loop);
- K = 2 on 2 ranks against K = 2 in one process at the global batch (each
  rank draws the global batch and keeps its rows; host-fed, the one
  process's rows are the ranks' in rank order), at the tolerances of
  tests/test_torch_parallel.py (losses rel 1e-5, parameters and BN
  statistics atol 2e-5): the same steps, their global sums in another
  order;
- ``main.run_experiment`` on the ranks (host-fed ``semi``, one epoch of 4
  steps, validation and test, inference), K = 2 against K = 1: rank 0's
  ``storage.csv`` rows equal;
- every trainer with ``data_parallel`` True and no ``unroll_refusal``
  builds on 2 ranks at K = 2; ``adv`` and the pretraining trainers refuse
  both, saying why.
"""
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.main import build_pretrain_run, parse_config
from contrastyou_tpu_torch.parallel.mesh import DataGroup
from contrastyou_tpu_torch.trainers import trainer_zoo
from torch_dp import UNROLL_KINDS, host_batches, run_unroll, spawn, unroll_worker

torch.set_num_threads(1)

W, K, STEPS = 2, 2, 4
TWO_RANKS = DataGroup(rank=0, size=W, device=torch.device("cpu"), process_group=None)
#: the run of ``main.run_experiment`` on the ranks
MAIN = ["Trainer.name=semi", "Arch.max_channel=32", "Trainer.device=cpu", "Trainer.max_epoch=1",
        "Trainer.num_batches=4", "Data.labeled_scan_num=2", "LabeledLoader.batch_size=2",
        "UnlabeledLoader.batch_size=2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_unroll")
    synthesize_acdc_like(root / "data", num_train_scans=4, num_val_scans=2, slices_per_scan=4,
                         size=32)
    spec = {"kinds": sorted(UNROLL_KINDS), "unroll": K, "steps": STEPS, "main": MAIN,
            "data": str(root / "data")}
    spawn(unroll_worker, W, spec, str(root))
    return root, [torch.load(root / f"unroll_rank{r}.pt") for r in range(W)]


@pytest.mark.parametrize("kind", sorted(UNROLL_KINDS))
def test_unroll_on_ranks_equals_one_step_calls(ranks, kind):
    _, res = ranks
    for r in res:
        one, many = r[kind][1], r[kind][K]
        assert torch.equal(one["losses"], many["losses"]), (one["losses"], many["losses"])
        assert set(one["state"]) == set(many["state"])
        for k, v in one["state"].items():
            assert torch.equal(v, many["state"][k]), k
        assert one["step"] == many["step"] == STEPS and many["replays"] == 0
    for k, v in res[0][kind][K]["state"].items():
        assert torch.equal(v, res[1][kind][K]["state"][k]), k


@pytest.mark.parametrize("kind", ["semi", "semi_host", "mt", "dmt"])
def test_unroll_on_ranks_matches_one_process(ranks, kind):
    _, res = ranks
    host = None
    if kind == "semi_host":
        parts = [host_batches(STEPS, 2, 32, 100 + r) for r in range(W)]
        host = [{k: __import__("numpy").concatenate([p[i][k] for p in parts]) for k in parts[0][i]}
                for i in range(STEPS)]
    one = run_unroll(kind, K, per_rank=2 * W, steps=STEPS, host=host)
    got = res[0][kind][K]
    torch.testing.assert_close(got["losses"], one["losses"], rtol=1e-5, atol=0)
    for k, v in one["state"].items():
        if k.startswith("model/") and v.is_floating_point():
            torch.testing.assert_close(got["state"][k], v, rtol=0, atol=2e-5, msg=k)


def test_run_experiment_on_ranks_unroll_matches_one_step_calls(ranks):
    root, _ = ranks
    rows = {k: (root / f"main_k{k}_r0" / "storage.csv").read_text().splitlines()
            for k in (1, K)}
    assert len(rows[1]) == 2 and rows[1] == rows[K]
    assert not any((root / f"main_k{K}_r1").iterdir())
    assert (root / f"main_k{K}_r0" / "inference_result.json").exists()


TAKE_K = ("semi", "ft", "mt", "mixup", "multicore", "dmt")


@pytest.mark.parametrize("name", sorted(trainer_zoo))
def test_which_trainers_take_unroll_on_ranks(name, tmp_path):
    """The trainers of ``TAKE_K`` build on 2 ranks at K = 2 (no collective
    runs at construction); the others refuse, naming JAX's loop."""
    cls = trainer_zoo[name]
    kw = dict(model=None, labeled_loader=None, save_dir=str(tmp_path / name),
              data_group=TWO_RANKS, unroll_steps=K)
    if name == "multicore":
        kw.update(true_num_classes=4)
    if name in TAKE_K:
        assert cls.data_parallel and cls.unroll_refusal is None
        cls(**kw)
    else:
        with pytest.raises(NotImplementedError, match=f"{cls.__name__} does not run on 2 ranks"):
            cls(**kw)
        with pytest.raises(NotImplementedError, match="one step a call"):
            cls(**{**kw, "data_group": None})


def test_pretrain_run_refuses_unroll_on_ranks():
    with pytest.raises(NotImplementedError, match="one step a call"):
        build_pretrain_run(parse_config(["-o", "Trainer.name=pretrain_decoder",
                                         f"Trainer.unroll_steps={K}"]),
                           device="cpu", dtype=torch.float32, raw_size=36, crop=32, n_scans=6,
                           max_channel=32, data_group=TWO_RANKS)
