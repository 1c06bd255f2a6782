"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

At first use ``nvcc`` (``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``)
compiles each source under ``csrc/`` into its own shared library with a plain
C interface, ``build/torch_kernels/lib<source>_<hash>.so`` at the repository
root, keyed by a hash of the source, the headers and the flags so an unchanged
tree is not rebuilt. All missing libraries are compiled at once, one ``nvcc``
process per source. Each library is bound with ctypes. A missing compiler or
a failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signature of every entry point, per library (source stem): name ->
#: argtypes (all return int)
SIGNATURES = {
    "tapconv": {
        "tapconv_num_partials": (_I, _I, _I, _I),
        "conv3x3_stats": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
        "upconv3x3_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "upconv3x3_dx": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "convbwd": {
        "convbwd_num_partials": (_I, _I, _I, _I, _I, _I),
        "conv_dw_taps": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
        "conv3x3_bwd_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "supcon": {
        "supcon_max_anchors": (_I,),
        "supcon_loss": (_P, _P, _I, _I, _F, _P, _P, _P, _P),
        "supcon_dz": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P),
    },
    "iic": {
        "iic_num_partials": (_I,) * 9,
        "iic_joints": (_P,) * 6 + (_I,) * 8 + (_P,),
        "iic_joints_bwd": (_P,) * 10 + (_I,) * 8 + (_P,),
    },
}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked at {nvcc} and on PATH): the CUDA "
            "kernels can only be built on a machine with the CUDA toolkit")
    return found


def sources() -> Dict[str, Path]:
    """stem -> ``.cu`` source of every library."""
    return {f.stem: f for f in sorted(CSRC.glob("*.cu"))}


def source_hash(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [sources()[stem], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}_{source_hash(stem)}.so"


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every library that does not exist yet, all ``nvcc`` processes
    started together; return stem -> library path. Each library is written to
    a temporary name and renamed, so a cut build never leaves a half-written
    library behind."""
    libs = {stem: library_path(stem) for stem in sources()}
    todo = {stem: lib for stem, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    running = {}
    for stem, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(sources()[stem])]
        running[stem] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for stem, (tmp, cmd, proc) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            continue
        if verbose:
            print(out)
        os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """Build if needed and bind the C signatures of library ``stem``."""
    lib = ctypes.CDLL(str(build()[stem]))
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str, stem: str) -> None:
    """Raise if a launch of library ``stem`` returned a CUDA error code."""
    if rc != 0:
        msg = getattr(load_library(stem), f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
