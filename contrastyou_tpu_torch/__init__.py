"""PyTorch / CUDA port of contrastyou_tpu for one NVIDIA H100.

The JAX package ``contrastyou_tpu`` is the reference; this package mirrors its
module paths and never imports it or JAX. Activations on the kernel path are
NHWC bf16; the wide U-Net levels run on hand-written CUDA kernels
(``ops/csrc``), built with nvcc at first use.

``DATA_PATH`` (the dataset root, ``$CONTRASTYOU_DATA_PATH``) and ``RUN_PATH``
(where relative ``Trainer.save_dir`` s go, ``$CONTRASTYOU_RUN_PATH``) default
to ``.data`` and ``runs`` beside the package, as in the JAX package; they are
read when the package is imported and created when a run needs them.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["PROJECT_PATH", "DATA_PATH", "RUN_PATH", "success"]

PROJECT_PATH = str(Path(__file__).resolve().parents[1])
DATA_PATH = os.environ.get("CONTRASTYOU_DATA_PATH", str(Path(PROJECT_PATH) / ".data"))
RUN_PATH = os.environ.get("CONTRASTYOU_RUN_PATH", str(Path(PROJECT_PATH) / "runs"))


def success(save_dir: str) -> None:
    """Write the ``.success`` marker of a finished run."""
    (Path(save_dir) / ".success").touch()
