"""Device-resident dataset cache: the train split lives in GPU memory and
each step samples and crops its batch there (counterpart of
contrastyou_tpu/data/device_cache.py). Sample indices and crop offsets come
from a ``torch.Generator`` on the cache's device (:meth:`sample`) or from the
caller (:meth:`sample_at`)."""
from __future__ import annotations

import typing as t

import numpy as np
import torch

__all__ = ["DeviceDataCache"]


class DeviceDataCache:
    def __init__(self, images: torch.Tensor, targets: torch.Tensor, *,
                 partition: torch.Tensor, patient: torch.Tensor,
                 cycle: torch.Tensor, scan_id: torch.Tensor,
                 scan_names: t.Sequence[str], crop: int):
        n, h, w = images.shape
        if crop > h or crop > w:
            raise ValueError(f"crop {crop} larger than slices {h}x{w}")
        self.images, self.targets = images, targets
        self.partition, self.patient, self.cycle = partition, patient, cycle
        self.scan_id = scan_id
        self.scan_names = list(scan_names)
        self.crop = int(crop)

    @classmethod
    def from_arrays(cls, images: np.ndarray, targets: np.ndarray, *,
                    crop: int, device, scan_id: t.Optional[np.ndarray] = None,
                    partition: t.Optional[np.ndarray] = None,
                    patient: t.Optional[np.ndarray] = None,
                    cycle: t.Optional[np.ndarray] = None,
                    scan_names: t.Optional[t.Sequence[str]] = None
                    ) -> "DeviceDataCache":
        """Stage [N, h, w] float images in [0, 1] and integer targets; the
        per-slice group ids default to 0."""
        n = len(images)

        def ids(a):
            a = np.zeros(n, np.int64) if a is None else np.asarray(a)
            return torch.as_tensor(a, dtype=torch.long, device=device)

        sid = ids(scan_id)
        names = (list(scan_names) if scan_names is not None
                 else [f"scan{i}" for i in range(int(sid.max()) + 1)])
        return cls(torch.as_tensor(np.asarray(images, np.float32), device=device),
                   torch.as_tensor(np.asarray(targets), dtype=torch.long, device=device),
                   partition=ids(partition), patient=ids(patient),
                   cycle=ids(cycle), scan_id=sid, scan_names=names, crop=crop)

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def device(self):
        return self.images.device

    def draw(self, generator: torch.Generator, batch_size: int):
        """-> (idx, oy, ox) [B] long: uniform indices, uniform crop offsets."""
        idx = torch.randint(0, len(self), (batch_size,), generator=generator,
                            device=self.device)
        return (idx, *self.draw_offsets(generator, batch_size))

    def draw_offsets(self, generator: torch.Generator, batch_size: int):
        """-> (oy, ox) [B] long: uniform crop offsets."""
        h, w = self.images.shape[1:]
        dev = self.device
        oy = torch.randint(0, h - self.crop + 1, (batch_size,), generator=generator, device=dev)
        ox = torch.randint(0, w - self.crop + 1, (batch_size,), generator=generator, device=dev)
        return oy, ox

    def sample(self, generator: torch.Generator, batch_size: int) -> dict:
        return self.sample_at(*self.draw(generator, batch_size))

    def sample_at(self, idx: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor) -> dict:
        """Batch of slices ``idx`` cropped at top-left ``(oy, ox)``, one
        gather: image [B, c, c, 1] f32, target [B, c, c] long, group ids."""
        c = self.crop
        ar = torch.arange(c, device=self.device)
        rows = (oy[:, None] + ar)[:, :, None]
        cols = (ox[:, None] + ar)[:, None, :]
        sl = idx[:, None, None]
        return {"image": self.images[sl, rows, cols][..., None],
                "target": self.targets[sl, rows, cols],
                "partition": self.partition[idx], "patient": self.patient[idx],
                "cycle": self.cycle[idx], "scan_id": self.scan_id[idx]}
