"""Parameter bridge between the JAX package's flax variables and this
package's torch ``state_dict`` s (counterpart of
contrastyou_tpu/utils/torch_convert.py, whose key map it ports). The map of
a net comes from its modules (:func:`key_map`); the U-Net's blocks:

  _ConvX.conv.0.weight  [O,I,3,3] <-> ConvX/conv0/kernel  [3,3,I,O]
  _ConvX.conv.1.*       (BN)      <-> ConvX/bn0/{scale,bias} + batch_stats
                        (GN)      <-> ConvX/gn0/{scale,bias}
  _ConvX.conv.3/.4                <-> ConvX/conv1, ConvX/bn1 (gn1)
  _UpX.up.1.weight, _UpX.up.2.*   <-> UpX/conv/kernel, UpX/bn/* (gn/*)
  _Deconv_1x1.weight/.bias        <-> Deconv_1x1/{kernel,bias}

and every other layer under its module path (the ResUNet encoder's
``_Conv1.ResidualBlock_0.Conv_0`` <-> ``Conv1/ResidualBlock_0/Conv_0``,
UNet2's flax names as they are; ``Dense`` weights transposed);

and the projection heads of the contrastive hooks, whose torch modules carry
the flax layer names:

  Dense_i.weight [O,I], .bias   <-> Dense_i/kernel [I,O], /bias   (ProjectionHead)
  Conv_i.weight [O,I,1,1], .bias <-> Conv_i/kernel [1,1,I,O], /bias (DenseProjectionHead)

and the cluster heads of the discrete-MI hooks, whose S subheads flax vmaps:

  weight [S,C,K], bias [S,K] <-> Vmap_SubHead_0/Dense_0/kernel [S,C,K], /bias [S,K]
                                 (ClusterHead)
                             <-> Vmap_DenseSubHead_0/Conv_0/kernel [S,1,1,C,K], /bias [S,K]
                                 (DenseClusterHead)

and, in the dense heads' ``mlp`` form (the cross-correlation block's
``CrossCorrelationProjector``), a hidden layer before it:

  hidden_weight [S,C,D], hidden_bias [S,D] <-> .../Conv_0
  weight [S,D,K], bias [S,K]               <-> .../Conv_1

The DAE hook's conv (``AuxLayer``, ``Conv_0`` [1,1,C,1] and its bias) takes
the projection heads' map.

and the mean-teacher hook states, whose U-Nets are flax trees in JAX and
``state_dict`` halves in the port:

  teacher_params / teacher_batch_stats / ema_step  (MT, UAMT, ICT, DMT)
  ema_params / ema_batch_stats / ema_step          (EvalEMAParameters)
  <-> {named_parameters}, {named_buffers}, int

with DMT's teacher optimizer beside them, optax's ``ScaleByAdamState`` inside
its chain state on the flax side:

  teacher_opt (count, mu, nu)  <-> {"count": int, "mu": {...}, "nu": {...}}

and the adversarial trainer's discriminator (models/discriminator.py):

  Conv_i.weight [O,I,4,4]           <-> Conv_i/kernel [4,4,I,O]
  BatchNorm_i.{scale,bias,mean,var} <-> BatchNorm_i/{scale,bias} + batch_stats
  Dense_0.weight [1,I], .bias       <-> Dense_0/kernel [I,1], /bias

Values are numpy arrays on the flax side and tensors on the torch side.

The ``Arch.pretrained_path`` warm start reads a local npz archive of
flax-keyed paths (``params/Conv1/conv0/kernel``, ``batch_stats/...``;
:func:`save_npz_tree` / :func:`load_npz_tree`) and overlays each leaf whose
path exists and whose shape matches onto the model (:func:`merge_pretrained`,
:func:`load_pretrained`), BN running statistics included.
"""
from __future__ import annotations

import functools
import typing as t

import numpy as np
import torch

__all__ = ["key_map", "flax_to_state_dict", "state_dict_to_flax", "flax_to_hook_state",
           "hook_state_to_flax", "flax_to_discriminator_state_dict",
           "discriminator_state_dict_to_flax", "flax_to_head_state_dict",
           "head_state_dict_to_flax", "flax_to_cluster_head_state_dict",
           "cluster_head_state_dict_to_flax", "convert_resnet_encoder", "save_npz_tree",
           "load_npz_tree",
           "merge_pretrained", "load_pretrained"]

def _layer_rows(module, key: str, path: tuple) -> list:
    """Rows of one parameter-holding layer, or None for a container."""
    from ..models.unet import BatchNorm, GroupNorm
    if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
        rows = [(f"{key}.weight", "params", path + ("kernel",),
                 "conv" if isinstance(module, torch.nn.Conv2d) else "dense")]
        if module.bias is not None:
            rows.append((f"{key}.bias", "params", path + ("bias",), "vec"))
        return rows
    if isinstance(module, (BatchNorm, GroupNorm, torch.nn.GroupNorm)):
        rows = [(f"{key}.weight", "params", path + ("scale",), "vec"),
                (f"{key}.bias", "params", path + ("bias",), "vec")]
        if isinstance(module, BatchNorm):
            rows += [(f"{key}.running_mean", "batch_stats", path + ("mean",), "vec"),
                     (f"{key}.running_var", "batch_stats", path + ("var",), "vec")]
        return rows
    return None


def _block_rows(module, key: str, path: tuple) -> list:
    """Rows of a U-Net ConvBlock or UpConv (the reference's torch names,
    the JAX package's ``conv0``/``bn0``/... or ``gn0``/... names), or
    None."""
    from ..models.unet import BatchNorm, ConvBlock, UpConv

    def norm_name(m, i=""):
        return ("bn" if isinstance(m, BatchNorm) else "gn") + i

    if isinstance(module, ConvBlock):
        c = module.conv
        parts = [(0, "conv0"), (1, norm_name(c[1], "0")), (3, "conv1"), (4, norm_name(c[4], "1"))]
        sub = "conv"
    elif isinstance(module, UpConv):
        parts = [(1, "conv"), (2, norm_name(module.up[2]))]
        sub = "up"
    else:
        return None
    rows = []
    for i, name in parts:
        rows += _layer_rows(getattr(module, sub)[i], f"{key}.{sub}.{i}", path + (name,))
    return rows


@functools.lru_cache(maxsize=None)
def _default_unet():
    from ..models.unet import UNet
    return UNet(max_channel=16, dtype=torch.float32)


def key_map(model: t.Optional[torch.nn.Module] = None) -> list:
    """-> [(torch key, flax collection, flax path, kind)] of ``model`` (by
    default the BatchNorm U-Net), kind one of 'conv' (OIHW <-> HWIO), 'dense'
    ([O, I] <-> [I, O]) or 'vec'. The map follows the model's modules: the
    U-Net blocks keep the reference's torch names; every other layer's flax
    path is its module path, a named layer's leading ``_`` dropped
    (``_Conv1.ResidualBlock_0.Conv_0`` <-> ``Conv1/ResidualBlock_0/Conv_0``,
    UNet2's ``ResnetBlock_3.GroupNorm_0`` as it is)."""
    model = _default_unet() if model is None else model
    named = set(getattr(model, "arch_elements", ()))
    rows = []

    def walk(module, key, path):
        found = _block_rows(module, key, path)
        if found is None:
            found = _layer_rows(module, key, path)
        if found is not None:
            rows.extend(found)
            return
        for name, child in module.named_children():
            flax = name[1:] if not key and name[1:] in named else name
            walk(child, f"{key}.{name}" if key else name, path + (flax,))

    walk(model, "", ())
    return rows


_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0)}
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


def flax_to_state_dict(params: t.Mapping, batch_stats: t.Mapping,
                       model: t.Optional[torch.nn.Module] = None) -> dict:
    """flax ``params`` + ``batch_stats`` (numpy leaves) -> the torch
    state_dict of ``model`` (:func:`key_map`; f32 tensors). Raises KeyError
    on a missing entry."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd = {}
    for key, coll, path, kind in key_map(model):
        node = trees[coll]
        for p in path:
            node = node[p]
        a = np.asarray(node, np.float32)
        if kind in _TO_TORCH:
            a = np.ascontiguousarray(np.transpose(a, _TO_TORCH[kind]))
        sd[key] = torch.tensor(a)
    return sd


def state_dict_to_flax(sd: t.Mapping[str, torch.Tensor],
                       model: t.Optional[torch.nn.Module] = None) -> dict:
    """Inverse of :func:`flax_to_state_dict` ->
    ``{"params": ..., "batch_stats": ...}`` with numpy leaves."""
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, kind in key_map(model):
        a = sd[key].detach().float().cpu().numpy()
        if kind in _TO_FLAX:
            a = np.transpose(a, _TO_FLAX[kind])
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


#: the U-Net halves of each mean-teacher hook state: (params, batch_stats)
HOOK_STATE_TREES = (("teacher_params", "teacher_batch_stats"), ("ema_params", "ema_batch_stats"))
_BUFFERS = (".running_mean", ".running_var")


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside a
    chain state."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    for part in (opt_state if isinstance(opt_state, (tuple, list)) else ()):
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def flax_to_hook_state(state: t.Mapping, model: t.Optional[torch.nn.Module] = None) -> dict:
    """A JAX mean-teacher or EMA hook state (flax trees and ``ema_step``; for
    DMT also the teacher's optax state) -> the port's: the parameters and the
    BN running statistics as two dicts keyed as the model's
    ``named_parameters`` / ``named_buffers`` (f32 tensors), ``ema_step`` an
    int, ``teacher_opt`` as :func:`~contrastyou_tpu_torch.hooks.dmt.adam_init`
    lays it out. ``model``: the net of the trees (:func:`key_map`)."""
    for p_key, s_key in HOOK_STATE_TREES:
        if p_key in state:
            def params_of(tree):
                sd = flax_to_state_dict(tree, state[s_key], model)
                return {k: v for k, v in sd.items() if not k.endswith(_BUFFERS)}

            sd = flax_to_state_dict(state[p_key], state[s_key], model)
            out = {p_key: params_of(state[p_key]),
                   s_key: {k: v for k, v in sd.items() if k.endswith(_BUFFERS)},
                   "ema_step": int(np.asarray(state["ema_step"]))}
            if "teacher_opt" in state:
                adam = _adam_state(state["teacher_opt"])
                out["teacher_opt"] = {"mu": params_of(adam.mu), "nu": params_of(adam.nu),
                                      "count": int(np.asarray(adam.count))}
            return out
    raise KeyError(f"not a mean-teacher hook state: {sorted(state)}")


def hook_state_to_flax(state: t.Mapping, model: t.Optional[torch.nn.Module] = None) -> dict:
    """Inverse of :func:`flax_to_hook_state` (numpy leaves, ``ema_step``
    int32; DMT's ``teacher_opt`` as ``{"count", "mu", "nu"}`` with flax
    parameter trees)."""
    for p_key, s_key in HOOK_STATE_TREES:
        if p_key in state:
            stats = state[s_key]
            tree = state_dict_to_flax({**state[p_key], **stats}, model)
            out = {p_key: tree["params"], s_key: tree["batch_stats"],
                   "ema_step": np.int32(state["ema_step"])}
            if "teacher_opt" in state:
                opt = state["teacher_opt"]
                out["teacher_opt"] = {
                    "count": np.int32(opt["count"]),
                    **{m: state_dict_to_flax({**opt[m], **stats}, model)["params"]
                       for m in ("mu", "nu")}}
            return out
    raise KeyError(f"not a mean-teacher hook state: {sorted(state)}")


def flax_to_discriminator_state_dict(params: t.Mapping, batch_stats: t.Mapping) -> dict:
    """The discriminator's flax ``params`` + ``batch_stats`` -> the port's
    ``Discriminator`` state_dict (f32 tensors)."""
    sd = {}
    for layer, leaves in params.items():
        if layer.startswith("Conv_"):
            sd[f"{layer}.weight"] = torch.tensor(
                np.transpose(np.asarray(leaves["kernel"], np.float32), (3, 2, 0, 1)))
        elif layer.startswith("Dense_"):
            sd[f"{layer}.weight"] = torch.tensor(np.asarray(leaves["kernel"], np.float32).T)
            sd[f"{layer}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))
        else:
            for k in ("scale", "bias"):
                sd[f"{layer}.{k}"] = torch.tensor(np.asarray(leaves[k], np.float32))
            for k in ("mean", "var"):
                sd[f"{layer}.{k}"] = torch.tensor(np.asarray(batch_stats[layer][k], np.float32))
    return sd


def discriminator_state_dict_to_flax(sd: t.Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_to_discriminator_state_dict` ->
    ``{"params": ..., "batch_stats": ...}`` with numpy leaves."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, v in sd.items():
        layer, leaf = key.split(".")
        a = v.detach().float().cpu().numpy()
        if layer.startswith("Conv_"):
            out["params"].setdefault(layer, {})["kernel"] = np.transpose(a, (2, 3, 1, 0))
        elif layer.startswith("Dense_"):
            out["params"].setdefault(layer, {})["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(a.T) if leaf == "weight" else a)
        else:
            coll = "batch_stats" if leaf in ("mean", "var") else "params"
            out[coll].setdefault(layer, {})[leaf] = a
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
    """flax params of a ``ClusterHead`` or a ``DenseClusterHead`` (linear or
    mlp) -> the state_dict of the port's head (f32 tensors)."""
    dense = CLUSTER_LAYERS[True][0] in params
    sub, layer = CLUSTER_LAYERS[dense]
    kind = layer.split("_")[0]
    layers = params[sub]
    names = [f"{kind}_0", f"{kind}_1"] if f"{kind}_1" in layers else [layer]
    keys = [("hidden_weight", "hidden_bias"), ("weight", "bias")][-len(names):]
    sd = {}
    for name, (wk, bk) in zip(names, keys):
        k = np.asarray(layers[name]["kernel"], np.float32)
        sd[wk] = torch.tensor(k.reshape(k.shape[0], -1, k.shape[-1]))
        sd[bk] = torch.tensor(np.asarray(layers[name]["bias"], np.float32))
    return sd


def cluster_head_state_dict_to_flax(sd: t.Mapping[str, torch.Tensor], *, dense: bool) -> dict:
    """Inverse of :func:`flax_to_cluster_head_state_dict`; ``dense`` picks the
    ``DenseClusterHead`` tree (1x1 conv kernels [S,1,1,C,K])."""
    sub, layer = CLUSTER_LAYERS[dense]
    kind = layer.split("_")[0]
    keys = [("weight", "bias")]
    if "hidden_weight" in sd:
        keys.insert(0, ("hidden_weight", "hidden_bias"))
    out = {}
    for i, (wk, bk) in enumerate(keys):
        w = sd[wk].detach().float().cpu().numpy()
        if dense:
            w = w[:, None, None]
        out[f"{kind}_{i}"] = {"kernel": np.ascontiguousarray(w),
                              "bias": sd[bk].detach().float().cpu().numpy()}
    return {sub: out}


def convert_resnet_encoder(sd: t.Mapping[str, np.ndarray]) -> dict:
    """A torchvision-named resnet state_dict (numpy arrays) -> the ResUNet
    encoder archive tree ``{"params", "batch_stats"}`` that the JAX
    package's ``tools/convert_torch_weights.py resnet-encoder`` writes:
    ``layer{i}.{j}.conv1/bn1/conv2/bn2/downsample.0`` onto
    ``Conv{i+1}/ResidualBlock_{j}/{Conv_0, BatchNorm_0, Conv_1, BatchNorm_1,
    Conv_2}``. The stem, the shortcut BN (``downsample.1``) and the head have
    no counterpart and are left out; tensors of another shape than the
    ResUNet's are skipped by :func:`load_pretrained`."""
    params: dict = {}
    stats: dict = {}
    convs = {"conv1": "Conv_0", "conv2": "Conv_1"}
    bns = {"bn1": "BatchNorm_0", "bn2": "BatchNorm_1"}
    leaves = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}

    def put(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) < 4 or not parts[0].startswith("layer"):
            continue
        block = (f"Conv{int(parts[0][5:]) + 1}", f"ResidualBlock_{int(parts[1])}")
        sub, leaf = parts[2], parts[-1]
        hwio = np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0))) if np.ndim(v) == 4 else v
        if sub in convs and leaf == "weight":
            put(params, block + (convs[sub], "kernel"), hwio)
        elif sub == "downsample" and parts[3] == "0" and leaf == "weight":
            put(params, block + ("Conv_2", "kernel"), hwio)
        elif sub in bns and leaf in leaves:
            coll, name = leaves[leaf]
            put(params if coll == "params" else stats, block + (bns[sub], name), v)
    return {"params": params, "batch_stats": stats}


def save_npz_tree(path: str, tree: t.Mapping) -> None:
    """Flatten a nested dict of arrays to ``a/b/c`` keys and save it as npz."""
    flat: dict = {}

    def rec(prefix, node):
        if isinstance(node, t.Mapping):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    np.savez(path, **flat)


def load_npz_tree(path: str) -> dict:
    """Inverse of :func:`save_npz_tree`."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def merge_pretrained(init_tree: t.Mapping, archive_tree: t.Mapping, _prefix: str = ""
                     ) -> t.Tuple[dict, t.List[str], t.List[str]]:
    """Overlay ``archive_tree``'s leaves onto ``init_tree`` where the path
    exists and the shape matches (torch ``load_state_dict(strict=False)``
    with a shape check) -> (merged, loaded paths, skipped paths: present but
    of another shape); the other leaves keep their values."""
    merged: dict = {}
    loaded: t.List[str] = []
    skipped: t.List[str] = []
    for k, v in init_tree.items():
        path = f"{_prefix}/{k}" if _prefix else str(k)
        if isinstance(v, t.Mapping):
            sub = archive_tree.get(k, {}) if isinstance(archive_tree, t.Mapping) else {}
            m, lo, sk = merge_pretrained(v, sub, path)
            merged[k] = m
            loaded += lo
            skipped += sk
        elif (isinstance(archive_tree, t.Mapping) and k in archive_tree
              and np.shape(archive_tree[k]) == np.shape(v)):
            merged[k] = np.asarray(archive_tree[k])
            loaded.append(path)
        else:
            merged[k] = v
            if isinstance(archive_tree, t.Mapping) and k in archive_tree:
                skipped.append(path)
    return merged, loaded, skipped


def _sorted(tree: t.Mapping) -> dict:
    return {k: _sorted(v) if isinstance(v, t.Mapping) else v for k, v in sorted(tree.items())}


def load_pretrained(model: torch.nn.Module, path: str) -> t.Tuple[t.List[str], t.List[str]]:
    """The ``Arch.pretrained_path`` warm start of a U-Net or ResUNet, in
    place (a ResUNet encoder archive: :func:`convert_resnet_encoder`): the
    archive's ``params`` and ``batch_stats`` merged into the model's own
    (:func:`merge_pretrained`, each tree on its own, as JAX's trainer does)
    -> (loaded, skipped) paths, the ``params`` ones first, each in the
    sorted key order of a flax tree."""
    tree = load_npz_tree(path)
    current = _sorted(state_dict_to_flax(model.state_dict(), model))
    params, lo_p, sk_p = merge_pretrained(current["params"], tree.get("params", {}))
    stats, lo_s, sk_s = merge_pretrained(current["batch_stats"], tree.get("batch_stats", {}))
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return lo_p + lo_s, sk_p + sk_s
