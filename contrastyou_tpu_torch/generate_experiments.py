"""Experiment grids for the PyTorch port (counterpart of
script/generate_experiments.py): the same ``METHODS`` (one hook preset, a
trainer and a sweep each), the same flat sweeps (:func:`build_commands`,
one command per labeled scan count and grid point) and pretrain ->
fine-tune chains (:func:`build_chained_commands`, ``--chain-ft``: one
pretrain job, then an ``ft`` job per labeled ratio of ``opt/<data>.yaml``
but the last, warm-started from ``<pretrain>/last``, with its ``pre_lr`` /
``ft_lr``; ``--per-class``: ACDC's lv, rv and myo apart), the same command
line; each command runs ``python -m contrastyou_tpu_torch.main`` with the
presets of ``config/`` (found at the repository root, beside this package;
``opt/`` is read with the port's YAML reader, so no PyYAML is needed).

    python -m contrastyou_tpu_torch.generate_experiments --method udaiic --data acdc \
        --labeled-scans 1 2 4 --save-dir runs/udaiic [--submit | --dry-run]
    python -m contrastyou_tpu_torch.generate_experiments --method infonce_ed_pretrain \
        --data acdc --chain-ft --per-class --save-dir runs/ied

Without ``--submit`` / ``--dry-run`` / ``--local`` the commands are
printed; with one of them each job goes through
:class:`~contrastyou_tpu_torch.submitter.SlurmSubmitter`: ``--dry-run``
prints its script, ``--submit`` hands it to ``sbatch``, ``--local`` runs it
here with ``bash``, one job after another (the JAX script has no
``--local``).
"""
from __future__ import annotations

import argparse
import typing as t
from pathlib import Path

from .configure.config import yaml_load
from .submitter import SlurmSubmitter, grid_search

__all__ = ["ROOT", "CONFIG", "OPT", "MAIN", "METHODS", "PER_CLASS", "build_commands",
           "build_chained_commands", "main"]

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "config"
OPT = ROOT / "opt"
#: the entry point each command runs
MAIN = "python -m contrastyou_tpu_torch.main"

# One entry per reference generator family. "grid" values are the reference
# sweeps (file:line cited per entry where they differ from the preset).
METHODS = {
    # --- comparison/ scripts + script_generator_{mt,ent,pl,adv,dmt}.py ---
    "baseline": {"hooks": [], "trainer": "ft", "grid": {}},
    "mt": {"hooks": ["mt.yaml"], "trainer": "mt",
           "grid": {"MeanTeacherParameters.weight": [0.1, 1, 10]}},
    "uamt": {"hooks": ["uamt.yaml"], "trainer": "mt",
             "grid": {"UAMeanTeacherParameters.weight": [0.1, 1, 10]}},
    "ict": {"hooks": ["ict.yaml"], "trainer": "mt",
            "grid": {"ICTMeanTeacherParameters.weight": [0.1, 1, 10]}},
    "entmin": {"hooks": ["entmin.yaml"], "trainer": "semi",
               "grid": {"EntropyMinParameters.weight": [0.0001, 0.001, 0.01]}},
    "pseudolabel": {"hooks": ["pseudolabel.yaml"], "trainer": "semi",
                    "grid": {"PsuedoLabelParams.weight": [0.01, 0.1, 1]}},
    "consistency": {"hooks": ["consistency.yaml"], "trainer": "semi",
                    "grid": {"ConsistencyParameters.weight": [1, 5, 10]}},
    "mixup": {"hooks": ["mixup.yaml"], "trainer": "mixup",
              "grid": {"MixUpParams.weight": [0.1, 1]}},
    "adv": {"hooks": ["adv.yaml"], "trainer": "adv",
            "grid": {"Trainer.reg_weight": [0.001, 0.01]}},
    "dmt": {"hooks": ["dmt.yaml"], "trainer": "dmt",
            "grid": {"DifferentiableMeanTeacherParameters.method_name":
                     ["method1", "method2", "method3", "method4",
                      "second_order"]}},
    # --- script_generator_discreteMI.py + comparison/script_discretemi.py ---
    "iid": {"hooks": ["iid.yaml"], "trainer": "semi",
            "grid": {"IIDSegParameters.weight": [0.01, 0.1]}},
    "udaiic": {"hooks": ["udaiic.yaml"], "trainer": "semi",
               "grid": {"DiscreteMIConsistencyParams.consistency_weight":
                        [1, 5]}},
    "imsat": {"hooks": ["imsat.yaml"], "trainer": "semi",
              "grid": {"IMSATParameters.weight": [0.01, 0.1]}},
    # --- script_generator_multicore{,_mt}.py:118-125 ---
    "multicore": {"hooks": ["multicore.yaml"], "trainer": "multicore",
                  "grid": {"IIDSegParameters.weight": [0.01, 0.02, 0.1],
                           "ConsistencyParameters.weight": [0, 0.01, 0.1, 0.5]}},
    "multicore_mt": {"hooks": ["multicore.yaml", "mt.yaml"],
                     "trainer": "multicore",
                     "grid": {"IIDSegParameters.weight": [0.01, 0.02, 0.1],
                              "MeanTeacherParameters.weight": [0.1, 1]}},
    # --- script_generator_neurips.py / script_generator_pretrain.py ---
    "infonce_pretrain": {"hooks": ["infonce_encoder.yaml"],
                         "trainer": "pretrain", "pretrain": True,
                         "grid": {"InfonceParams.contrast_ons":
                                  ["partition", "patient", "self"]}},
    "spinfonce_pretrain": {"hooks": ["spinfonce.yaml"], "trainer": "pretrain",
                           "pretrain": True,
                           "grid": {"SPInfonceParams.begin_values": [100, 10000],
                                    "SPInfonceParams.mode": ["soft", "hard"]}},
    # --- script_generator_pretrain_infonce_ed.py:43-63 (encoder+dense) ---
    "infonce_ed_pretrain": {"hooks": ["infonce_encoder_dense.yaml"],
                            "trainer": "pretrain_decoder", "pretrain": True,
                            "grid": {"InfonceParams.weights":
                                     ["[1,0.1]", "[1,1]"],
                                     "InfonceParams.spatial_size":
                                     ["[1,9]", "[1,16]"]}},
    # --- script_generator_pretrain_cc.py:30-46 (encoder infonce + cc) ---
    "pretrain_cc": {"hooks": ["infonce_encoder.yaml", "ccblocks2.yaml"],
                    "trainer": "pretrain_decoder", "pretrain": True,
                    "grid": {"CrossCorrelationParameters.hooks.cc.weight":
                             [0.1, 1]}},
    # --- script_generator_pretrain_infonce_e_cc_d.py (encoder infonce,
    #     decoder cc) — same presets, cc on the decoder feature ---
    "infonce_e_cc_d_pretrain": {
        "hooks": ["infonce_encoder.yaml", "ccblocks2.yaml"],
        "trainer": "pretrain_decoder", "pretrain": True,
        "grid": {"CrossCorrelationParameters.feature_name":
                 ["Up_conv3", "Up_conv2"]}},
    # --- script_generator_pretrain_clusters.py:32-46 (imsat clusters) ---
    "pretrain_clusters": {"hooks": ["ccblocks_imsat.yaml"],
                          "trainer": "pretrain_decoder", "pretrain": True,
                          "grid": {"CrossCorrelationParameters.num_clusters":
                                   [20, 40],
                                   "CrossCorrelationParameters.hooks.imsat.use_dynamic":
                                   ["true", "false"]}},
    # --- script_generator_pretrain_superpixel_d.py ---
    "superpixel_pretrain": {"hooks": ["infonce_dense_superpixel.yaml"],
                            "trainer": "pretrain_decoder", "pretrain": True,
                            "grid": {}},
    # --- ccblock semi regularization (pretrain_cc.py run_semi variants) ---
    "ccblocks": {"hooks": ["ccblocks2.yaml"], "trainer": "semi",
                 "grid": {"CrossCorrelationParameters.num_clusters": [10, 20, 40],
                          "CrossCorrelationParameters.hooks.rr.alpha":
                          [0.0, 0.5, 1.0]}},
}

PER_CLASS = ("lv", "rv", "myo")  # ACDC per-class finetune datasets


def _opt(data: str) -> dict:
    path = OPT / f"{data}.yaml"
    return yaml_load(path) if path.exists() else {}


def _main_cmd(configs, opts) -> str:
    return f"{MAIN} -p " + " ".join(configs) + " -o " + " ".join(opts)


def build_commands(method: str, data: str, labeled_scans, save_dir: str,
                   max_epoch: t.Optional[int] = None, seed: int = 10):
    """One command per (labeled_scans x grid point) — the flat sweep shape of
    the comparison/ and semi generators."""
    spec = METHODS[method]
    configs = [str(CONFIG / "base.yaml")]
    if spec.get("pretrain"):
        configs.append(str(CONFIG / "pretrain.yaml"))
    configs += [str(CONFIG / "hooks" / h) for h in spec["hooks"]]
    commands = []
    for scans in labeled_scans:
        for i, grid_point in enumerate(grid_search(**spec["grid"]) if
                                       spec["grid"] else [{}]):
            opts = [f"RandomSeed={seed}",
                    f"Trainer.name={spec['trainer']}", f"Data.name={data}",
                    f"Data.labeled_scan_num={scans}",
                    f"Trainer.save_dir={save_dir}/{method}/{data}/"
                    f"scan{scans}/run{i}"]
            if max_epoch:
                opts.append(f"Trainer.max_epoch={max_epoch}")
            opts += [f"{k}={v}" for k, v in grid_point.items()]
            commands.append(_main_cmd(configs, opts))
    return commands


def build_chained_commands(method: str, data: str, save_dir: str, *,
                           per_class: bool = False, seed: int = 10,
                           max_epoch_pretrain: t.Optional[int] = None,
                           max_epoch: t.Optional[int] = None):
    """Pretrain→finetune chains (ref script_generator_pretrain_cc.py:150-180):
    for each pretrain grid point, one pretrain job plus one ft job per
    labeled ratio, warm-started via Arch.checkpoint. Ratios/lrs come from
    opt/{data}.yaml; the last ratio (fully labeled) is skipped, matching
    ``labeled_ratios[:-1]`` in every reference generator."""
    spec = METHODS[method]
    if not spec.get("pretrain"):
        raise ValueError(f"--chain-ft needs a pretrain method, got {method}")
    opt = _opt(data.removesuffix("_lv").removesuffix("_rv").removesuffix("_myo"))
    ratios = opt.get("labeled_ratios", [1, 2, 4])[:-1]
    pre_lr = opt.get("pre_lr")
    ft_lr = opt.get("ft_lr")
    pre_configs = [str(CONFIG / "base.yaml"), str(CONFIG / "pretrain.yaml")]
    pre_configs += [str(CONFIG / "hooks" / h) for h in spec["hooks"]]
    ft_configs = [str(CONFIG / "base.yaml")]
    jobs = []  # each job: list of shell commands chained with &&
    for i, grid_point in enumerate(grid_search(**spec["grid"]) if
                                   spec["grid"] else [{}]):
        run_dir = f"{save_dir}/{method}/{data}/run{i}"
        pre_dir = f"{run_dir}/pretrain"
        pre_opts = [f"RandomSeed={seed}", f"Trainer.name={spec['trainer']}",
                    f"Data.name={data}", f"Trainer.save_dir={pre_dir}"]
        if max_epoch_pretrain:
            pre_opts.append(f"Trainer.max_epoch={max_epoch_pretrain}")
        if pre_lr is not None:
            pre_opts.append(f"Optim.lr={pre_lr:.10f}")
        pre_opts += [f"{k}={v}" for k, v in grid_point.items()]
        chain = [_main_cmd(pre_configs, pre_opts)]
        ckpt = f"{pre_dir}/last"
        for ratio in ratios:
            targets = ([f"{data}_{c}" for c in PER_CLASS]
                       if per_class and data == "acdc" else [data])
            for tgt in targets:
                sub = tgt.split("_")[-1] if tgt != data else "all"
                ft_opts = [f"RandomSeed={seed}", "Trainer.name=ft",
                           f"Data.name={tgt}",
                           f"Data.labeled_scan_num={ratio}",
                           f"Arch.checkpoint={ckpt}",
                           f"Trainer.save_dir={run_dir}/tra/"
                           f"labeled_num_{ratio:03d}/{sub}"]
                if max_epoch:
                    ft_opts.append(f"Trainer.max_epoch={max_epoch}")
                if ft_lr is not None:
                    ft_opts.append(f"Optim.lr={ft_lr:.10f}")
                chain.append(_main_cmd(ft_configs, ft_opts))
        jobs.append(" && \\\n".join(chain))
    return jobs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--method", required=True, choices=sorted(METHODS))
    parser.add_argument("--data", default="acdc")
    parser.add_argument("--labeled-scans", type=int, nargs="+", default=[1])
    parser.add_argument("--save-dir", default="runs/sweep")
    parser.add_argument("--max-epoch", type=int, default=None)
    parser.add_argument("--max-epoch-pretrain", type=int, default=None)
    parser.add_argument("--seed", type=int, nargs="+", default=[10])
    parser.add_argument("--chain-ft", action="store_true",
                        help="emit pretrain→per-ratio finetune job chains")
    parser.add_argument("--per-class", action="store_true",
                        help="ACDC: finetune lv/rv/myo separately")
    parser.add_argument("--submit", action="store_true")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--local", action="store_true",
                        help="run each job here with bash, in turn (a failing job raises)")
    args = parser.parse_args(argv)

    commands = []
    for seed in args.seed:
        if args.chain_ft:
            commands += build_chained_commands(
                args.method, args.data, args.save_dir,
                per_class=args.per_class, seed=seed,
                max_epoch_pretrain=args.max_epoch_pretrain,
                max_epoch=args.max_epoch)
        else:
            commands += build_commands(args.method, args.data,
                                       args.labeled_scans, args.save_dir,
                                       args.max_epoch, seed=seed)
    if args.submit or args.dry_run or args.local:
        sub = SlurmSubmitter(work_dir=str(Path.cwd()), dry_run=args.dry_run,
                             on_local=args.local)
        for cmd in commands:
            sub.submit(cmd)
    else:
        print("\n\n".join(commands))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
