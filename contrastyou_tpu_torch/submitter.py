"""Job submission for experiment grids (counterpart of
contrastyou_tpu/submitter.py, which writes the same script text for the same
arguments): each job command becomes a bash script with ``#SBATCH`` headers
(time, memory, CPUs, optional GRES, an account from a cycled list),
``set -e`` when ``stop_on_error``, the environment exports and a ``cd`` to
the work directory. ``dry_run`` prints the script; ``on_local`` runs it with
``bash`` here (a failing job raises when ``stop_on_error``); otherwise it
goes to ``sbatch``."""
from __future__ import annotations

import itertools
import os
import subprocess
import tempfile
import typing as t

__all__ = ["grid_search", "SlurmSubmitter"]


def grid_search(**param_lists: t.Sequence) -> t.Iterator[dict]:
    """The Cartesian product of named value lists, one dict per point."""
    keys = list(param_lists)
    for values in itertools.product(*(param_lists[k] for k in keys)):
        yield dict(zip(keys, values))


class SlurmSubmitter:
    def __init__(self, *, work_dir: str = ".", stop_on_error: bool = True,
                 on_local: bool = False, dry_run: bool = False,
                 account_list: t.Sequence[str] = (), time: int = 4,
                 mem: int = 16, cpus: int = 6, gres: t.Optional[str] = None):
        self._work_dir = str(work_dir)
        self._stop_on_error = stop_on_error
        self._on_local = on_local
        self._dry_run = dry_run
        self._accounts = itertools.cycle(account_list) if account_list else None
        self._sbatch_params = {"time": f"0-{time:02d}:00", "mem": f"{mem}000M",
                               "cpus-per-task": str(cpus)}
        if gres:
            self._sbatch_params["gres"] = gres
        self._env_exports: t.List[str] = []
        self.submitted: t.List[str] = []

    def configure_environment(self, commands: t.Sequence[str]) -> None:
        """Shell lines (e.g. ``export VAR=...``) run before each job."""
        self._env_exports = list(commands)

    def configure_sbatch(self, **kwargs) -> None:
        self._sbatch_params.update({k.replace("_", "-"): str(v) for k, v in kwargs.items()})

    def _script(self, job: str) -> str:
        lines = ["#!/bin/bash"]
        for key, value in self._sbatch_params.items():
            lines.append(f"#SBATCH --{key}={value}")
        if self._accounts is not None:
            lines.append(f"#SBATCH --account={next(self._accounts)}")
        if self._stop_on_error:
            lines.append("set -e")
        lines += self._env_exports
        lines.append(f"cd {self._work_dir}")
        lines.append(job)
        return "\n".join(lines) + "\n"

    def submit(self, job: str, *, on_local: t.Optional[bool] = None) -> str:
        """Write, then print, run or queue ``job``'s script; returns its text."""
        script = self._script(job)
        self.submitted.append(script)
        if self._dry_run:
            print(script)
            return script
        local = self._on_local if on_local is None else on_local
        fd, path = tempfile.mkstemp(suffix=".sh")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(script)
            code = subprocess.call(["bash", path] if local else ["sbatch", path])
        finally:
            os.unlink(path)
        if code != 0 and self._stop_on_error:
            raise RuntimeError(f"job failed with code {code}:\n{script}")
        return script
