"""Cluster plots of decoder pretraining (counterpart of the root
plot_pretrain_cluster.py, the reference's cluster-plot entry point).

    python -m contrastyou_tpu_torch.plot_pretrain_cluster \\
        -p config/base.yaml config/hooks/udaiic.yaml \\
        -o DiscreteMIConsistencyParams.feature_names=[Up_conv2] \\
           DiscreteMIConsistencyParams.mi_weights=[0.05] Trainer.save_dir=plot_cluster

JAX's ``main`` step for step: the config (``-p`` presets, or
config/base.yaml's in-code equal; ``-o`` overrides), the data split for
pretraining (``get_data(pretrain=True)``), :class:`PretrainDecoderTrainer`
on the contrastive loader over the labeled half, the hooks made with
``is_pretrain=False`` (config/hooks/udaiic.yaml's discrete-MI and
consistency hooks, or config/hooks/ccblocks2.yaml's block), ``init`` and
training. Then :func:`dump_cluster_maps` writes into
``<save_dir>/cluster_plots``, for each cluster hook (a head over a tapped
layer): the first subhead's argmax map of each of the first 8 validation
batches (``<hook>_b<i>.npy``, int32 [B, h, w]) after a train-mode forward
with batch statistics that leaves the running ones alone; a montage PNG a
batch (``<hook>_b<i>.png``: the first ``min(4, B)`` images in grey above
their cluster maps in the tab20 palette, nearest-upsampled); the
Hungarian-aligned ``cluster_acc`` and ``mapping`` against the labels
subsampled to the map's size (``cluster_metrics.json``); and the t-SNE of
the features pooled per slice, coloured by partition (``<hook>_tsne.png``,
``postprocess/tsne.py``, on the run's device). Beside them,
``launches.json`` records the hand-written kernels' launches of the
training and of the dump, the seconds of each, the trainer's ``timing``
records and each t-SNE's size, seconds and exact KL divergence.

A cluster hook whose head pools the map (a ``ClusterHead`` on an encoder
layer, as config/hooks/udaiic.yaml's ``Conv5``) raises before training:
its "map" is one id a slice, on which JAX's script fails after training
(``plot_pretrain_cluster.py:115``, from ``:80``). ``-o Trainer.device=cpu``
runs on the CPU; without a card and without it the script raises.
"""
from __future__ import annotations

import json
import logging
import sys
import time
import typing as t
from pathlib import Path

import numpy as np
import torch

import contrastyou_tpu_torch as package
from .data.creator import get_data
from .data.datasets import dataset_spec
from .data.png import write_png
from .engine.bundle import ModelBundle
from .engine.trainer import kernel_launches
from .hooks.savers import norm_uint8
from .loggers import setup_logging
from .main import (_BASE, _hooks, _model, _timing_records, parse_config, refuse_unported_keys,
                   resolve_device)
from .models.projectors import ClusterHead
from .postprocess.cluster import cluster_alignment, hungarian_match
from .postprocess.tsne import TAB20, exact_tsne, scatter_image
from .trainers.pretrain import PretrainDecoderTrainer, get_contrastive_loader
from .utils.rng import fix_all_seed

__all__ = ["MAX_BATCHES", "cluster_hooks", "check_cluster_hooks", "dump_cluster_maps",
           "downsample_labels", "montage", "main"]

logger = logging.getLogger(__name__)

#: validation batches dumped a hook (JAX ``dump_cluster_maps``'s ``max_batches``)
MAX_BATCHES = 8


def cluster_hooks(hooks: t.Sequence) -> list:
    """The hooks with a head over a named tapped layer (JAX ``_cluster_hooks``:
    a ``projector``, a ``_feature_name``, not on the logits)."""
    return [h for h in hooks if getattr(h, "projector", None) is not None
            and getattr(h, "_feature_name", None) and not getattr(h, "_on_logits", False)]


def check_cluster_hooks(hooks: t.Sequence) -> list:
    """:func:`cluster_hooks`, raising when there is none or when a head pools
    its map (one id a slice, no map to draw)."""
    found = cluster_hooks(hooks)
    if not found:
        raise ValueError("no cluster-producing hook registered: a head over a tapped layer is "
                         "needed (config/hooks/udaiic.yaml or ccblocks2.yaml)")
    pooled = [h.name for h in found if isinstance(h.projector, ClusterHead)]
    if pooled:
        raise NotImplementedError(
            f"cluster hook(s) {pooled}: the head pools the feature map to one cluster id a "
            f"slice, so there is no map to plot (JAX's plot_pretrain_cluster.py fails on it "
            f"after training, at :115 from :80); keep the decoder layers, e.g. -o "
            f"DiscreteMIConsistencyParams.feature_names=[Up_conv2] "
            f"DiscreteMIConsistencyParams.mi_weights=[0.05]")
    return found


def downsample_labels(labels: np.ndarray, hw: t.Tuple[int, int]) -> np.ndarray:
    """[B, H, W] -> [B, h, w]: the labels at rows ``i * H // h`` and columns
    ``j * W // w`` (JAX ``_downsample_labels``)."""
    h, w = hw
    H, W = labels.shape[1:]
    return labels[:, np.arange(h) * H // h][:, :, np.arange(w) * W // w]


def montage(images: np.ndarray, assigns: np.ndarray, gap: int = 4) -> np.ndarray:
    """RGB uint8: the first ``min(4, B)`` images ([B, H, W, 1] in [0, 1]) in
    grey over their cluster maps ([B, h, w] ids) in the tab20 palette,
    nearest-upsampled to the image size, ``gap`` white pixels apart."""
    n = min(4, images.shape[0])
    H, W = images.shape[1:3]
    h, w = assigns.shape[1:]
    rows, cols = np.arange(H) * h // H, np.arange(W) * w // W
    out = np.full((2 * H + gap, n * W + (n - 1) * gap, 3), 255, np.uint8)
    for i in range(n):
        x0 = i * (W + gap)
        out[:H, x0:x0 + W] = norm_uint8(images[i, ..., 0])[..., None]
        ids = assigns[i][rows][:, cols]
        out[H + gap:, x0:x0 + W] = TAB20[np.asarray(ids) % len(TAB20)]
    return out


@torch.no_grad()
def dump_cluster_maps(bundle: ModelBundle, hooks: t.Sequence, loader, out_dir,
                      max_batches: int = MAX_BATCHES, device=None,
                      tsne_stats: t.Optional[dict] = None) -> dict:
    """The files of the module docstring for each cluster hook of ``hooks``
    -> ``{hook name: {"cluster_acc", "mapping"}}``; ``tsne_stats`` gets each
    hook's t-SNE size, seconds, exact KL and iterations."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = torch.device(device) if device is not None else next(
        bundle.model.parameters()).device
    bundle.model.train()
    results = {}
    for hook in check_cluster_hooks(hooks):
        stem = hook.name.replace("/", "_")
        clusters_all, labels_all, feats_all, parts_all = [], [], [], []
        for bi, batch in enumerate(loader):
            if bi >= max_batches:
                break
            image = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
            _, taps = bundle.apply_train(image, taps=(hook._feature_name,), update_stats=False)
            feat = taps[hook._feature_name]
            assign = hook.projector(feat.float())[0].argmax(-1).int().cpu().numpy()
            clusters_all.append(assign)
            labels_all.append(np.asarray(batch["target"]))
            feats_all.append(feat.mean((1, 2)).float().cpu().numpy())
            parts_all.append(np.asarray(batch["partition"]))
            np.save(out_dir / f"{stem}_b{bi}.npy", assign)
            write_png(out_dir / f"{stem}_b{bi}.png", montage(np.asarray(batch["image"]), assign))
        clusters = np.concatenate(clusters_all)
        sub = downsample_labels(np.concatenate(labels_all), clusters.shape[1:])
        flat_c, flat_r = clusters.reshape(-1), sub.reshape(-1)
        k = int(max(flat_c.max(), flat_r.max()) + 1)
        mapping = hungarian_match(flat_c, flat_r, k)
        aligned = cluster_alignment(flat_c, flat_r, num_clusters=k)
        results[hook.name] = {"cluster_acc": float((aligned == flat_r).mean()),
                              "mapping": {int(a): int(b) for a, b in mapping.items()}}
        t0 = time.perf_counter()
        feats = np.concatenate(feats_all)
        emb = exact_tsne(feats, device=device)
        write_png(out_dir / f"{stem}_tsne.png", scatter_image(emb.embedding,
                                                            np.concatenate(parts_all)))
        if tsne_stats is not None:
            tsne_stats[hook.name] = {"n": len(feats), "seconds": time.perf_counter() - t0,
                                     "kl_divergence": emb.kl_divergence, "n_iter": emb.n_iter}
    return results


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    setup_logging()
    config = parse_config(argv, base=_BASE)
    refuse_unported_keys(config)
    device = resolve_device(config["Trainer"].get("device"))
    seed = int(config.get("RandomSeed", 10))
    fix_all_seed(seed)
    data = config["Data"]
    data_name = str(data["name"])
    labeled, unlabeled, val, _ = get_data(
        data, config.get("LabeledLoader", {}), config.get("UnlabeledLoader", {}),
        root_dir=package.DATA_PATH, pretrain=True, order_num=int(data.get("order_num", 0)))
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16
    model = _model(config, device, dtype, None, gen, dataset_spec(data_name).train_classes)
    clp = {k: v for k, v in config.get("ContrastiveLoaderParams", {}).items()
           if k != "num_workers"}
    trainer = PretrainDecoderTrainer(
        model=model, labeled_loader=labeled, unlabeled_loader=unlabeled, val_loader=None,
        test_loader=None, contrast_loader=get_contrastive_loader(
            labeled.dataset, data_name=data_name, seed=seed, **clp),
        config=config, seed=seed,
        **{k: v for k, v in config["Trainer"].items() if k not in ("name", "device")})
    # the hooks made with is_pretrain=False, as JAX's script makes them
    hooks = _hooks(config, model, device, dtype, gen, is_pretrain=False, trainer=trainer)
    check_cluster_hooks(hooks)
    trainer.register_hooks(*hooks)
    trainer.init()
    t0 = time.perf_counter()
    with _timing_records() as timing:
        trainer.start_training()
    trained, t1 = kernel_launches(), time.perf_counter()
    out_dir = Path(trainer.save_dir) / "cluster_plots"
    tsne: dict = {}
    results = dump_cluster_maps(trainer._bundle, trainer._hooks, val, out_dir, device=device,
                                tsne_stats=tsne)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dumped = kernel_launches()
    logger.info("cluster plots -> %s: %s", out_dir, results)
    (out_dir / "cluster_metrics.json").write_text(json.dumps(results))
    (out_dir / "launches.json").write_text(json.dumps(
        {"launches": {"train": trained, "dump": {k: v - trained.get(k, 0)
                                                 for k, v in dumped.items()}},
         "seconds": {"train": t1 - t0, "dump": time.perf_counter() - t1}, "timing": timing,
         "tsne": tsne},
        indent=2))
    return results


if __name__ == "__main__":
    main()
