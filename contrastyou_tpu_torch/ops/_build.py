"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

At first use ``nvcc`` (``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``)
compiles every source under ``csrc/`` into one shared library with a plain C
interface, ``build/torch_kernels/libtapconv_<hash>.so`` at the repository
root, keyed by a hash of the sources and flags so an unchanged tree is not
rebuilt. The library is bound with ctypes. A missing compiler or a failed
build raises with the compiler's output; nothing falls back.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C signature of every entry point: name -> argtypes (all return int)
SIGNATURES = {
    "tapconv_num_tiles": (_I, _I),
    "conv3x3_stats": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "upconv3x3_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "upconv3x3_dx": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
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


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the hashed library already exists; return
    its path. The library is written to a temporary name and renamed, so a
    cut build never leaves a half-written library behind."""
    lib = BUILD_DIR / f"libtapconv_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(f) for f in _sources() if f.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and bind every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tapconv_error_string.argtypes = [ctypes.c_int]
    lib.tapconv_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load_library().tapconv_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
