"""The ``pretrain`` cells: the port's contrastive pretraining step (two
views, one forward cut at the deepest tapped layer, the InfoNCE hooks, RAdam
over the layers up to it and the heads), one update a call, its batches
from the contrastive sampler over synthetic scans held on the device."""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import inputs, reference as ref
from ..check import Readings
from ..work import conv_flops, kernel_sites, matmul_flops, unet_convs
from . import base
from .base import half_batch, no_synthetic_slices, readings_of


def infonce_specs(config: dict) -> List[ref.InfoNCESpec]:
    """The InfoNCE hooks of ``InfonceParams``, named as the port names them."""
    p = config["InfonceParams"]
    names = p["feature_names"]
    names = [names] if isinstance(names, str) else list(names)

    def per_hook(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * len(names)

    out = []
    for f, w, c, s in zip(names, per_hook(p["weights"]), per_hook(p["contrast_ons"]),
                          per_hook(p["spatial_size"])):
        grid = None if f in ref.ENCODER else (int(s), int(s))
        out.append(ref.InfoNCESpec(f"infonce/{f}/{c}", f, float(w), c, grid))
    return out


def deepest(specs) -> str:
    order = list(ref.ENCODER) + [conv for _, conv, _ in ref.DECODER]
    return max((s.layer for s in specs), key=order.index)


class Runner(base.Runner):

    def _layout(self):
        t = self.traffic
        return (int(t["raw_size"]), int(t["crop"]), int(t["scans"]), int(t["slices_per_scan"]))

    def _hook_shapes(self) -> Dict[str, tuple]:
        out = {}
        for h in infonce_specs(self.config):
            dim = ref.channel_dim(h.layer, self.max_channel)
            for k, s in ref.head_shapes("encoder" if h.grid is None else "dense", dim).items():
                out[f"{h.name}:{k}"] = s
        return out

    def _trainable(self, pshapes) -> List[str]:
        until = deepest(infonce_specs(self.config))
        order = list(ref.ENCODER) + [x for up, conv, _ in ref.DECODER for x in (up, conv)]
        kept = order[:order.index(until) + 1]
        return [k for k in pshapes if k.split(".")[0][1:] in kept]

    def build(self) -> None:
        from contrastyou_tpu_torch import main as port
        raw, crop, scans, per_scan = self._layout()
        self.config["Data"]["name"] = self.traffic["data_name"]
        self.config.setdefault("ContrastiveLoaderParams", {})["scan_sample_num"] = int(
            self.traffic["scan_sample_num"])
        with no_synthetic_slices(port):
            run = port.build_pretrain_run(self.config, device=self.device, dtype=self.dtype,
                                          raw_size=raw, crop=crop, n_scans=scans,
                                          slices_per_scan=per_scan)
        nc = int(self.traffic["num_classes"])
        pshapes, bshapes = ref.unet_shapes(self.max_channel, nc)
        hshapes = self._hook_shapes()
        weights = inputs.make_weights({**pshapes, **hshapes},
                                      inputs.generator(self.seed, inputs.WEIGHTS, self.device))
        model = run.state.model
        model.load_state_dict({**{k: weights[k] for k in pshapes},
                               **inputs.make_buffers(bshapes, self.device)})
        hooks = {h.name: h for h in run.hooks}
        for name in {k.split(":")[0] for k in hshapes}:
            pre = f"{name}:"
            hooks[name].load_state_dict({k[len(pre):]: v for k, v in weights.items()
                                         if k.startswith(pre)})
        images, targets = inputs.make_slices(scans * per_scan, raw, nc, inputs.generator(
            self.seed, inputs.SLICES, self.device))
        run.cache.images.copy_(images)
        run.cache.targets.copy_(targets)
        if self.fault == "half_batch":
            self.plant(run.cache, "sample_at", lambda f: half_batch(f, None))
            self.plant(port, "sample_pretrain_draws", half_batch)
        self.run = run
        self.gen = inputs.generator(self.seed, inputs.DRAWS, self.device)
        self.slices_per_update = run.batch_slices
        self.names = {id(p): k for k, p in model.named_parameters()}
        for h in run.hooks:
            if isinstance(h, torch.nn.Module):
                self.names.update({id(p): f"{h.name}:{k}" for k, p in h.named_parameters()})
        trainable = set(self._trainable(pshapes)) | set(hshapes)
        self.initial = {k: v.detach().clone() for k, v in self.leaves().items()
                        if k in trainable or k in bshapes}

    def call(self):
        run = self.run
        return run.step(run.state, self.gen)

    def loss_of(self, metrics) -> torch.Tensor:
        return metrics["reg_loss"]

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = dict(self.run.state.model.state_dict())
        for h in self.run.hooks:
            if isinstance(h, torch.nn.Module):
                out.update({f"{h.name}:{k}": v for k, v in h.state_dict().items()})
        if self.initial:
            out = {k: v for k, v in out.items() if k in self.initial}
        return out

    # --- work ------------------------------------------------------------
    def _batch(self) -> int:
        return 2 * self.slices_per_update       # both views

    def _convs(self):
        return unet_convs(self.max_channel, int(self.traffic["num_classes"]),
                          int(self.traffic["crop"]), until=deepest(infonce_specs(self.config)))

    def sites(self) -> list:
        return kernel_sites(self._convs(), self._batch())

    def model_flops(self) -> float:
        """The U-Net up to the cut, the heads (the dense head's second 1x1
        conv at the pooled grid, where it computes the same function) and
        the similarity products."""
        B = self._batch()
        convs = self._convs()
        res = {c.layer.split(".")[0]: c.h for c in convs}
        total = conv_flops(convs, B)
        per_view = B // 2
        for h in infonce_specs(self.config):
            c = ref.channel_dim(h.layer, self.max_channel)
            if h.grid is None:
                total += matmul_flops(B, c, ref.PROJ_DIM) + matmul_flops(B, ref.PROJ_DIM, ref.PROJ_DIM)
                anchors = B
            else:
                total += matmul_flops(B * res[h.layer] ** 2, c, ref.PROJ_DIM)
                total += matmul_flops(B * h.grid[0] * h.grid[1], ref.PROJ_DIM, ref.PROJ_DIM)
                anchors = 2 * per_view * ref.POINT_NUMS
            total += matmul_flops(anchors, ref.PROJ_DIM, anchors)
        return total

    # --- the reference ---------------------------------------------------
    def reference(self, prec, n_calls: int) -> Readings:
        dev = self.device
        raw, crop, scans, per_scan = self._layout()
        nc = int(self.traffic["num_classes"])
        specs = infonce_specs(self.config)
        pshapes, bshapes = ref.unet_shapes(self.max_channel, nc)
        hshapes = self._hook_shapes()
        weights = inputs.make_weights({**pshapes, **hshapes},
                                      inputs.generator(self.seed, inputs.WEIGHTS, dev))
        buffers = inputs.make_buffers(bshapes, dev)
        images, _ = inputs.make_slices(scans * per_scan, raw, nc, inputs.generator(
            self.seed, inputs.SLICES, dev))
        partitions = int(self.traffic["partition_num"])
        partition = torch.tensor([ref.partition_index(i % per_scan, per_scan, partitions)
                                  for i in range(scans * per_scan)], device=dev)
        trainable = self._trainable(pshapes) + list(hshapes)
        state = ref.State(weights, buffers, trainable, self.config, prec)
        start = {**{k: state.params[k].detach().clone() for k in trainable},
                 **{k: v.clone() for k, v in state.buffers.items()}}
        g = inputs.generator(self.seed, inputs.DRAWS, dev)
        order = ref.random_order(scans * per_scan, self.seed)
        batch = int(self.traffic["scan_sample_num"]) * partitions
        grids = sorted({h.grid for h in specs if h.grid is not None})
        jitter = float(self.traffic["color_jitter"])
        losses, first = [], {}
        for i in range(n_calls):
            idx = torch.tensor(ref.batches_of(order, batch), device=dev)
            d = ref.pretrain_draws(g, size=raw, crop=crop, batch=batch, color_jitter=jitter,
                                   grids=grids)
            losses.append(ref.pretrain_step(state, images, partition, idx, d, crop=crop,
                                            until=deepest(specs), hooks=specs))
            if i == 0:
                first = {k: v.clone() for k, v in state.opt.mu.items()}
        end = {**{k: state.params[k].detach() for k in trainable}, **state.buffers}
        return readings_of(losses, first, start, end)
