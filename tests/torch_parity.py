"""Shared helpers of the tests that hold the PyTorch port
(contrastyou_tpu_torch) against the JAX package on the CPU: data moves
between the two as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy / jax array -> torch tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or jax array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def oihw(k) -> torch.Tensor:
    """flax HWIO kernel -> torch OIHW weight."""
    return t(np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1)))


def hwio(w: torch.Tensor) -> np.ndarray:
    """torch OIHW weight (or its grad) -> HWIO numpy."""
    return np.transpose(n(w), (2, 3, 1, 0))


def load_block(block: torch.nn.Module, params, stats, convs, bns) -> None:
    """Copy one flax block's variables into a port block: ``convs`` maps a
    flax conv name to the port's conv module, ``bns`` a flax BN name to the
    port's BatchNorm module."""
    with torch.no_grad():
        for name, conv in convs.items():
            conv.weight.copy_(oihw(params[name]["kernel"]))
        for name, bn in bns.items():
            bn.weight.copy_(t(params[name]["scale"]))
            bn.bias.copy_(t(params[name]["bias"]))
            bn.running_mean.copy_(t(stats[name]["mean"]))
            bn.running_var.copy_(t(stats[name]["var"]))


def close(got, ref, *, rtol: float, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(n(got), n(ref), rtol=rtol, atol=atol, err_msg=what)


def scaled_close(got, ref, *, tol: float, what: str = "") -> None:
    """max |got - ref| <= tol * max |ref| (for bf16, where the error scales
    with the largest value rather than with each element)."""
    g, r = n(got), n(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    err = np.abs(g - r).max()
    scale = max(np.abs(r).max(), 1e-30)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} * {scale:.3e}"
