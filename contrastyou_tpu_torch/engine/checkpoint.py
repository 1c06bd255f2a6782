"""Checkpoints that restore a whole run (counterpart of
contrastyou_tpu/engine/checkpoint.py). A checkpoint is a directory:

- ``train_state.pt`` (``torch.save``): the model's ``state_dict`` (BN running
  statistics included), the optimizer's ``state_dict`` and its update count
  (RAdam keeps it outside ``state_dict``; the schedule reads it), each hook
  module's ``state_dict``, the hook states (a mean teacher's or an EMA's:
  two dicts of tensors and the int ``ema_step``) and ``step``;
- ``host_state.pkl``: ``cur_epoch``, ``best_score``, ``config`` and the
  metric history (``storage``).

It is written to a temporary directory beside the target, then renamed over
it. The JAX package's checkpoints (``train_state.msgpack``) are not read.
:func:`extract_model_params` takes the model's parameters alone out of a
checkpoint, for a warm start (``Arch.checkpoint``).
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "train_state_dict", "load_train_state",
           "is_checkpoint", "extract_model_params", "load_model_params"]

TRAIN_STATE, HOST_STATE, JAX_TRAIN_STATE = "train_state.pt", "host_state.pkl", "train_state.msgpack"


def is_checkpoint(path) -> bool:
    """A checkpoint directory of either package (so a JAX run directory is
    refused by :func:`load_checkpoint` rather than trained over)."""
    path = Path(path)
    return (path / TRAIN_STATE).exists() or (path / JAX_TRAIN_STATE).exists()


def train_state_dict(state, hooks) -> Dict[str, Any]:
    """The device state of a :class:`~contrastyou_tpu_torch.engine.state.TrainState`."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "optimizer_count": int(getattr(state.optimizer, "count", 0)),
            "hooks": {h.name: h.state_dict() for h in hooks if isinstance(h, torch.nn.Module)},
            "hook_states": dict(state.hook_states),
            "step": int(state.step)}


def load_train_state(state, hooks, saved: Dict[str, Any]) -> None:
    """Restore :func:`train_state_dict`'s output into ``state`` and the hook
    modules, in place."""
    state.model.load_state_dict(saved["model"])
    modules = {h.name: h for h in hooks if isinstance(h, torch.nn.Module)}
    if set(modules) != set(saved["hooks"]):
        raise ValueError(f"checkpoint hook modules {sorted(saved['hooks'])}, "
                         f"run has {sorted(modules)}")
    for name, sd in saved["hooks"].items():
        modules[name].load_state_dict(sd)
    state.optimizer.load_state_dict(saved["optimizer"])
    if hasattr(state.optimizer, "count"):
        state.optimizer.count = int(saved["optimizer_count"])
    state.hook_states.clear()
    state.hook_states.update(saved["hook_states"])
    state.step = int(saved["step"])


def save_checkpoint(path, *, train_state: Dict[str, Any], host_state: Dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=str(path.parent)))
    try:
        torch.save(train_state, tmp / TRAIN_STATE)
        with open(tmp / HOST_STATE, "wb") as f:
            pickle.dump(dict(host_state), f)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def load_checkpoint(path, map_location=None) -> Dict[str, Any]:
    """-> ``{"train_state": ..., "host_state": ...}`` of a checkpoint
    directory, tensors on ``map_location``."""
    path = Path(path)
    if not (path / TRAIN_STATE).exists():
        if (path / JAX_TRAIN_STATE).exists():
            raise ValueError(f"{path} holds a JAX checkpoint ({JAX_TRAIN_STATE}, flax msgpack); "
                             f"the PyTorch port reads its own {TRAIN_STATE} only")
        raise FileNotFoundError(f"{path}: no {TRAIN_STATE}")
    train_state = torch.load(path / TRAIN_STATE, map_location=map_location, weights_only=True)
    with open(path / HOST_STATE, "rb") as f:
        host_state = pickle.load(f)
    return {"train_state": train_state, "host_state": host_state}


def extract_model_params(path, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of ``model`` (``named_parameters``) out of the
    checkpoint directory ``path``, on the model's device: as JAX restores the
    ``params`` subtree alone, the BN running statistics (buffers of the saved
    ``state_dict``), the optimizer and the hooks are left out. A saved tensor
    of another shape than the model's raises, naming it (JAX's train step
    refuses it at its first trace)."""
    template = dict(model.named_parameters())
    device = next(iter(template.values())).device
    saved = load_checkpoint(path, map_location=device)["train_state"]["model"]
    missing = sorted(set(template) - set(saved))
    if missing:
        raise KeyError(f"{path}: no saved {missing}")
    for name, p in template.items():
        if saved[name].shape != p.shape:
            raise ValueError(f"{path}: {name} is {list(saved[name].shape)} in the checkpoint, "
                             f"{list(p.shape)} in the model (another class count or width?)")
    return {name: saved[name] for name in template}


@torch.no_grad()
def load_model_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy :func:`extract_model_params`'s output into ``model``'s
    parameters, in place; its buffers (BN statistics) stay as they are."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameters {sorted(set(own) ^ set(params))} on one side only")
    for name, p in own.items():
        p.copy_(params[name])
