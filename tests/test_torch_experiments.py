"""The port's experiment tooling against the JAX package's: the grid
generator (``script/generate_experiments.py``), the submitter and the
report, and that these modules import nothing of JAX or of the
dependencies the card's machine lacks."""
from __future__ import annotations

import importlib.util
import math
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

from contrastyou_tpu import report as jax_report
from contrastyou_tpu import submitter as jax_submitter
from contrastyou_tpu.configure.config import ConfigParser as JaxConfigParser
from contrastyou_tpu_torch import generate_experiments as gen
from contrastyou_tpu_torch import report, submitter
from contrastyou_tpu_torch.main import parse_config

REPO = Path(__file__).resolve().parents[1]
JAX_MAIN, PORT_MAIN = "python main.py", "python -m contrastyou_tpu_torch.main"


def _jax_generator():
    spec = importlib.util.spec_from_file_location("jax_generate_experiments",
                                                  REPO / "script/generate_experiments.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JGEN = _jax_generator()
PRETRAIN = sorted(m for m, s in JGEN.METHODS.items() if s.get("pretrain"))


def _port(commands):
    return [c.replace(JAX_MAIN, PORT_MAIN) for c in commands]


def test_methods_are_jaxs():
    assert gen.METHODS == JGEN.METHODS and len(gen.METHODS) == 23
    assert gen.CONFIG == JGEN.CONFIG and gen.OPT == JGEN.OPT


@pytest.mark.parametrize("data", ["acdc", "prostate"])
@pytest.mark.parametrize("method", sorted(JGEN.METHODS))
def test_flat_grid_is_jaxs(method, data):
    for kw in ({}, {"max_epoch": 3, "seed": 2}):
        want = JGEN.build_commands(method, data, [1, 4], "runs/sweep", **kw)
        got = gen.build_commands(method, data, [1, 4], "runs/sweep", **kw)
        assert got == _port(want) and all(c.startswith(PORT_MAIN + " -p ") for c in got)


@pytest.mark.parametrize("per_class", [False, True], ids=["all", "per_class"])
@pytest.mark.parametrize("data", ["acdc", "prostate"])
@pytest.mark.parametrize("method", PRETRAIN)
def test_chains_are_jaxs(method, data, per_class):
    kw = dict(per_class=per_class, seed=3, max_epoch_pretrain=5, max_epoch=4)
    want = JGEN.build_chained_commands(method, data, "runs/chain", **kw)
    assert gen.build_chained_commands(method, data, "runs/chain", **kw) == _port(want)
    with pytest.raises(ValueError, match="pretrain method"):
        gen.build_chained_commands("mt", data, "runs/chain")


def _argvs(method: str):
    """Every command of ``method``'s flat grid and chains on ACDC (the
    chains per class too), as the entry point's argv."""
    jobs = gen.build_commands(method, "acdc", [1, 2], "runs/sweep")
    if method in PRETRAIN:
        jobs += gen.build_chained_commands(method, "acdc", "runs/chain", per_class=True)
    for job in jobs:
        for command in job.split(" && \\\n"):
            words = shlex.split(command)
            assert words[:3] == ["python", "-m", "contrastyou_tpu_torch.main"]
            yield words[3:]


def _outcome(parse, argv):
    try:
        return parse(argv)
    except KeyError as e:
        return ("KeyError", str(e))


#: methods whose grid sets a key its presets lack, so JAX's parser refuses
#: every command of it (``multicore`` and ``multicore_mt``:
#: ``IIDSegParameters.weight`` without ``+``); the port's refuses them alike
REFUSED_BY_JAX = {"multicore", "multicore_mt"}


@pytest.mark.parametrize("method", sorted(JGEN.METHODS))
def test_each_command_configures_the_run_jax_configures(method):
    """The port's ``parse_config`` of each emitted argv equals JAX's
    ``ConfigParser`` on the same ``-p`` files and ``-o`` overrides, or both
    refuse it with the same missing key."""
    n = refused = 0
    for argv in _argvs(method):
        want = _outcome(lambda a: JaxConfigParser().parse(a).to_dict(), argv)
        got = _outcome(parse_config, argv)
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and got[1].split(";")[0] == want[1].split(";")[0], argv
            refused += 1
        else:
            assert got == want, argv
        n += 1
    assert n >= 1 and (refused == n if method in REFUSED_BY_JAX else refused == 0)


def test_cli_prints_jaxs_commands_and_scripts(capsys, monkeypatch):
    for args in (["--method", "udaiic", "--labeled-scans", "1", "2"],
                 ["--method", "infonce_ed_pretrain", "--chain-ft", "--per-class"],
                 ["--method", "mt", "--dry-run", "--seed", "1", "2", "--max-epoch", "3"]):
        monkeypatch.setattr(sys, "argv", ["generate_experiments.py", *args])
        JGEN.main()
        want = capsys.readouterr().out
        assert gen.main(args) == 0
        assert capsys.readouterr().out == want.replace(JAX_MAIN, PORT_MAIN)


SUBMITTER_CASES = [
    dict(),
    dict(account_list=["a", "b"], time=8, mem=32, cpus=2, gres="gpu:1", stop_on_error=False),
]


@pytest.mark.parametrize("kw", SUBMITTER_CASES, ids=["default", "accounts"])
def test_submitter_dry_run_script_is_jaxs(kw, capsys):
    jobs = ["python -m contrastyou_tpu_torch.main -o Trainer.name=semi", "echo two", "echo 3"]
    subs = [mod.SlurmSubmitter(work_dir="/work", dry_run=True, **kw)
            for mod in (jax_submitter, submitter)]
    for s in subs:
        s.configure_environment(["export CONTRASTYOU_DATA_PATH=/data", "set -x"])
        s.configure_sbatch(job_name="grid", partition="gpu")
        for job in jobs:
            s.submit(job)
    assert subs[0].submitted == subs[1].submitted
    assert list(submitter.grid_search(a=[1, 2], b="xy")) == list(
        jax_submitter.grid_search(a=[1, 2], b="xy"))


def test_local_submit_runs_and_a_failing_job_raises(tmp_path):
    sub = submitter.SlurmSubmitter(work_dir=str(tmp_path), on_local=True)
    sub.submit("echo ok > done.txt")
    assert (tmp_path / "done.txt").read_text() == "ok\n"
    with pytest.raises(RuntimeError, match="job failed with code 3"):
        sub.submit("true && \\\n(exit 3) && \\\necho never > never.txt")
    assert not (tmp_path / "never.txt").exists()
    submitter.SlurmSubmitter(work_dir=str(tmp_path), on_local=True,
                             stop_on_error=False).submit("exit 4")


def _storage(path: Path, header, rows):
    path.mkdir(parents=True)
    lines = [",".join([""] + header)] + [",".join(map(str, r)) for r in rows]
    (path / "storage.csv").write_text("\n".join(lines) + "\n")


def _runs(top: Path) -> None:
    """Run directories of every case the best-epoch rule must get right."""
    cols = ["tra/tra/sup_loss/value", "val/eval/dice/DSC1", "val/eval/dice/DSC_mean",
            "test/eval/dice/DSC_mean"]
    _storage(top / "a/tie", cols, [[0, 1.5, 0.1, 0.25, 0.2], [1, 1.0, 0.2, 0.5, 0.3],
                                  [2, 0.5, 0.3, 0.5, 0.4]])
    _storage(top / "b/empty_cells", cols, [[0, 1.5, "", "", 0.2], [1, 1.0, 0.2, 0.125, ""],
                                          [2, "", 0.3, 0.75, 0.4], [3, 0.1, 0.4, "", 0.5]])
    _storage(top / "c/lower", cols, [[0, 2.0, 0.1, 0.9, 0.1], [1, 1.0, 0.2, 0.1, 0.1],
                                    [2, 3.0, 0.3, 0.1, 0.3]])
    _storage(top / "d/all_empty", cols, [[0, 1.0, 0.1, "", 0.1], [1, 1.0, 0.2, "", 0.2]])
    _storage(top / "e/other_columns", ["tra/pretrain/reg_loss/value"], [[0, 5.0], [1, 4.0]])
    _storage(top / "f/ints", ["val/eval/dice/DSC_mean", "val/x/count"],
             [[0, 0.5, 3], [1, 0.25, 4]])
    _storage(top / "g/repr", cols, [[0, 0.30000000000000004, 1e-05, 1.5e-07, 123456789.123],
                                   [1, 1e+16, 0.2, 1e-07, 0.1]])
    (top / "h").mkdir()
    (top / "h/storage.csv").write_text("")


def _same_summary(port: Path, jax: Path) -> None:
    """The same header and rows, cell for cell; a float cell within 1 ulp
    of pandas' (its default C parser reads some 17-digit floats 1 ulp off,
    e.g. ``0.30000000000000004`` as 0.3; the port's reader is exact)."""
    import csv
    with open(port, newline="") as a, open(jax, newline="") as b:
        got, want = list(csv.reader(a)), list(csv.reader(b))
    assert len(got) == len(want) and (not got or got[0] == want[0])
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if g != w:
                assert math.isclose(float(g), float(w), rel_tol=2.3e-16, abs_tol=0), (g, w)


@pytest.mark.parametrize("args", [
    ["--classes", "DSC_mean"],
    ["--classes", "DSC_mean", "DSC1", "--high_better", "false"],
    ["--classes", "DSC", "loss", "--anchor", "test/eval/dice/DSC_mean"],
    ["--classes", "nothing"],
], ids=["dsc_mean", "lower_better", "anchor", "none"])
def test_report_summary_is_pandas(tmp_path, args):
    """``summary.csv`` is byte for byte what the JAX report writes with
    pandas: the rows, the best epoch (the first extreme, empty anchor cells
    ignored), every selected column."""
    _runs(tmp_path / "runs")
    common = ["-t", str(tmp_path / "runs"), *args]
    frame = jax_report.main(common + ["--save_dir", str(tmp_path / "jax")])
    rows = report.main(common + ["--save_dir", str(tmp_path / "port")])
    _same_summary(tmp_path / "port/summary.csv", tmp_path / "jax/summary.csv")
    assert [r["folder"] for r in rows] == list(frame.get("folder", []))
    assert [r["best_epoch"] for r in rows] == [int(e) for e in frame.get("best_epoch", [])]
    for r, (_, j) in zip(rows, frame.iterrows()):
        for k, v in r.items():
            w = j[k]
            assert (v == w or (isinstance(v, float) and math.isnan(v) and math.isnan(w))
                    or math.isclose(v, w, rel_tol=2.3e-16, abs_tol=0)), k


def test_report_specific_folders(tmp_path):
    _runs(tmp_path / "runs")
    args = ["-s", str(tmp_path / "runs/a"), str(tmp_path / "runs/c"), "--classes", "DSC_mean"]
    jax_report.main(args + ["--save_dir", str(tmp_path / "jax")])
    assert len(report.main(args + ["--save_dir", str(tmp_path / "port")])) == 2
    _same_summary(tmp_path / "port/summary.csv", tmp_path / "jax/summary.csv")


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "contrastyou_tpu", "yaml", "pandas", "tensorboardX",
             "tensorboard", "matplotlib", "PIL", "tqdm")


def test_tooling_imports_none_of_jax_pyyaml_pandas_tensorboard_matplotlib_pil_tqdm(tmp_path):
    """``main``, ``generate_experiments``, ``report`` and ``writer`` import
    and run with those modules blocked (``import torch`` itself may load
    tqdm; nothing beyond it does)."""
    code = f"""
import sys
import torch
base = set(sys.modules)
for name in {FORBIDDEN!r}:
    if name not in sys.modules:
        sys.modules[name] = None
import contrastyou_tpu_torch.main, contrastyou_tpu_torch.generate_experiments as g
import contrastyou_tpu_torch.report as r, contrastyou_tpu_torch.writer as w
g.main(["--method", "infonce_ed_pretrain", "--chain-ft"])
r.main(["-t", {str(tmp_path)!r}, "--classes", "DSC_mean", "--save_dir", {str(tmp_path)!r}])
writer = w.SummaryWriter({str(tmp_path)!r})
writer.add_scalar("x", 1.0, 0)
writer.close()
assert w.read_events(writer.path)[0]["value"] == 1.0
bad = [m for m in set(sys.modules) - base
       if m.split('.')[0] in {FORBIDDEN!r} and sys.modules[m] is not None]
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "contrastyou_tpu_torch.main" in out.stdout
