"""Parameter bridge between the JAX package's flax U-Net variables and this
package's torch U-Net ``state_dict`` (counterpart of
contrastyou_tpu/utils/torch_convert.py, whose key map it ports):

  _ConvX.conv.0.weight  [O,I,3,3] <-> ConvX/conv0/kernel  [3,3,I,O]
  _ConvX.conv.1.*       (BN)      <-> ConvX/bn0/{scale,bias} + batch_stats
  _ConvX.conv.3/.4                <-> ConvX/conv1, ConvX/bn1
  _UpX.up.1.weight, _UpX.up.2.*   <-> UpX/conv/kernel, UpX/bn/*
  _Deconv_1x1.weight/.bias        <-> Deconv_1x1/{kernel,bias}

and the projection heads of the contrastive hooks, whose torch modules carry
the flax layer names:

  Dense_i.weight [O,I], .bias   <-> Dense_i/kernel [I,O], /bias   (ProjectionHead)
  Conv_i.weight [O,I,1,1], .bias <-> Conv_i/kernel [1,1,I,O], /bias (DenseProjectionHead)

and the cluster heads of the discrete-MI hooks, whose S subheads flax vmaps:

  weight [S,C,K], bias [S,K] <-> Vmap_SubHead_0/Dense_0/kernel [S,C,K], /bias [S,K]
                                 (ClusterHead)
                             <-> Vmap_DenseSubHead_0/Conv_0/kernel [S,1,1,C,K], /bias [S,K]
                                 (DenseClusterHead)

Values are numpy arrays on the flax side and tensors on the torch side.
"""
from __future__ import annotations

import typing as t

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax", "flax_to_head_state_dict",
           "head_state_dict_to_flax", "flax_to_cluster_head_state_dict",
           "cluster_head_state_dict_to_flax"]

CONV_BLOCKS = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5",
               "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2")
UP_BLOCKS = ("Up5", "Up4", "Up3", "Up2")


def _key_map():
    """-> [(torch key, flax collection, flax path, kind)] with kind one of
    'conv' (OIHW <-> HWIO) or 'vec'."""
    rows = []

    def bn(prefix, path):
        rows.extend([(f"{prefix}.weight", "params", path + ("scale",), "vec"),
                     (f"{prefix}.bias", "params", path + ("bias",), "vec"),
                     (f"{prefix}.running_mean", "batch_stats", path + ("mean",), "vec"),
                     (f"{prefix}.running_var", "batch_stats", path + ("var",), "vec")])

    for name in CONV_BLOCKS:
        base = f"_{name}.conv"
        rows.append((f"{base}.0.weight", "params", (name, "conv0", "kernel"), "conv"))
        bn(f"{base}.1", (name, "bn0"))
        rows.append((f"{base}.3.weight", "params", (name, "conv1", "kernel"), "conv"))
        bn(f"{base}.4", (name, "bn1"))
    for name in UP_BLOCKS:
        base = f"_{name}.up"
        rows.append((f"{base}.1.weight", "params", (name, "conv", "kernel"), "conv"))
        bn(f"{base}.2", (name, "bn"))
    rows.append(("_Deconv_1x1.weight", "params", ("Deconv_1x1", "kernel"), "conv"))
    rows.append(("_Deconv_1x1.bias", "params", ("Deconv_1x1", "bias"), "vec"))
    return rows


def flax_to_state_dict(params: t.Mapping, batch_stats: t.Mapping) -> dict:
    """flax ``params`` + ``batch_stats`` (numpy leaves) -> torch state_dict
    (f32 tensors). Raises KeyError on a missing entry."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd = {}
    for key, coll, path, kind in _key_map():
        node = trees[coll]
        for p in path:
            node = node[p]
        a = np.asarray(node, np.float32)
        if kind == "conv":
            a = np.transpose(a, (3, 2, 0, 1))
        sd[key] = torch.tensor(a)
    return sd


def state_dict_to_flax(sd: t.Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_to_state_dict` ->
    ``{"params": ..., "batch_stats": ...}`` with numpy leaves."""
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, kind in _key_map():
        a = sd[key].detach().float().cpu().numpy()
        if kind == "conv":
            a = np.transpose(a, (2, 3, 1, 0))
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def flax_to_head_state_dict(params: t.Mapping) -> dict:
    """flax params of a projection head (``Dense_i`` / ``Conv_i`` layers) ->
    the state_dict of the port's head (f32 tensors)."""
    sd = {}
    for layer, leaves in params.items():
        k = np.asarray(leaves["kernel"], np.float32)
        if layer.startswith("Dense_"):
            w = k.T
        elif layer.startswith("Conv_"):
            w = np.transpose(k, (3, 2, 0, 1))
        else:
            raise KeyError(f"unknown head layer {layer!r}")
        sd[f"{layer}.weight"] = torch.tensor(np.ascontiguousarray(w))
        sd[f"{layer}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))
    return sd


def head_state_dict_to_flax(sd: t.Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_to_head_state_dict`."""
    out: dict = {}
    for key, v in sd.items():
        layer, kind = key.rsplit(".", 1)
        a = v.detach().float().cpu().numpy()
        if kind == "weight":
            a = a.T if layer.startswith("Dense_") else np.transpose(a, (2, 3, 1, 0))
        out.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = \
            np.ascontiguousarray(a)
    return out


#: flax path of a cluster head's linear layer: (vmapped subhead, layer)
CLUSTER_LAYERS = {False: ("Vmap_SubHead_0", "Dense_0"), True: ("Vmap_DenseSubHead_0", "Conv_0")}


def flax_to_cluster_head_state_dict(params: t.Mapping) -> dict:
    """flax params of a ``ClusterHead`` or ``DenseClusterHead`` (linear) ->
    the state_dict of the port's head (f32 tensors)."""
    dense = CLUSTER_LAYERS[True][0] in params
    sub, layer = CLUSTER_LAYERS[dense]
    leaves = params[sub][layer]
    k = np.asarray(leaves["kernel"], np.float32)
    S, K = k.shape[0], k.shape[-1]
    return {"weight": torch.tensor(k.reshape(S, -1, K)),
            "bias": torch.tensor(np.asarray(leaves["bias"], np.float32))}


def cluster_head_state_dict_to_flax(sd: t.Mapping[str, torch.Tensor], *, dense: bool) -> dict:
    """Inverse of :func:`flax_to_cluster_head_state_dict`; ``dense`` picks the
    ``DenseClusterHead`` tree (1x1 conv kernel [S,1,1,C,K])."""
    w = sd["weight"].detach().float().cpu().numpy()
    if dense:
        w = w[:, None, None]
    sub, layer = CLUSTER_LAYERS[dense]
    return {sub: {layer: {"kernel": np.ascontiguousarray(w),
                          "bias": sd["bias"].detach().float().cpu().numpy()}}}
