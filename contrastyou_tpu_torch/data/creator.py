"""Datasets, deterministic splits and loaders of a run (counterpart of
contrastyou_tpu/data/creator.py): the archive's ``train`` and ``val`` modes
with the dataset's host transforms; the labeled / unlabeled split by the
ordering JSON ``{data}_ordering_{order_num}.json`` (first k scans labeled)
when the archive has one, else a split seeded with 2; ``val`` split into
validation and test scans (45%, mmwhs 40%); endless shuffled train loaders,
and eval loaders of one scan per batch (acdc, prostate) or of 4 slices.
"""
from __future__ import annotations

import json
import logging
import os
import typing as t

import numpy as np

from ..augment.host import transform_zoo
from .base import SliceDataset, extract_sub_dataset_based_on_scan_names
from .datasets import data_zoo
from .loader import BatchLoader
from .sampler import InfiniteRandomSampler, ScanBatchSampler

__all__ = ["configure_test_ratio", "create_tra_test_dataset", "split_dataset",
           "split_dataset_with_predefined_filenames", "create_infinite_loader",
           "create_val_loader", "get_data"]

logger = logging.getLogger(__name__)


def configure_test_ratio(data_name: str) -> float:
    return 0.4 if data_name.startswith("mmwhs") else 0.45


def create_tra_test_dataset(name: str, root_dir: str):
    spec = transform_zoo[name]()
    tra_set = data_zoo[name](root_dir=root_dir, mode="train", transforms=spec.train)
    test_set = data_zoo[name](root_dir=root_dir, mode="val", transforms=spec.val)
    overlap = set(tra_set.get_scan_list()) & set(test_set.get_scan_list())
    if overlap:
        raise ValueError(f"train/test scan overlap: {sorted(overlap)}")
    return tra_set, test_set


def split_dataset_with_predefined_filenames(dataset: SliceDataset, data_name: str,
                                            labeled_scan_nums: int, order_num: int = 0):
    order_file = os.path.join(dataset.root_dir, f"{data_name}_ordering_{order_num}.json")
    if not os.path.exists(order_file):
        order_file = os.path.join(dataset.root_dir, f"{data_name}_ordering.json")
    with open(order_file) as f:
        ordering: t.List[str] = json.load(f)
    if set(dataset.get_scan_list()) != set(ordering):
        raise ValueError(f"{order_file} does not list the dataset's scans")
    if labeled_scan_nums > len(ordering):
        raise ValueError(f"labeled_scan_nums {labeled_scan_nums} > {len(ordering)} scans")
    labeled = ordering[:labeled_scan_nums]
    unlabeled = sorted(set(dataset.get_scan_list()) - set(labeled))
    return [extract_sub_dataset_based_on_scan_names(dataset, names)
            for names in (labeled, unlabeled)]


def split_dataset(dataset: SliceDataset, *scan_nums: int, seed: int = 1) -> t.List[SliceDataset]:
    """Consecutive runs of ``scan_nums`` scans of a seeded permutation of the
    sorted scans, then the rest."""
    scans = sorted(set(dataset.get_scan_list()))
    if sum(scan_nums) > len(scans):
        raise ValueError(f"split {scan_nums} of {len(scans)} scans")
    permuted = np.random.default_rng(seed).permutation(scans).tolist()
    out, start = [], 0
    for n in scan_nums:
        out.append(extract_sub_dataset_based_on_scan_names(dataset, permuted[start:start + n]))
        start += n
    out.append(extract_sub_dataset_based_on_scan_names(dataset, permuted[start:]))
    return out


def create_infinite_loader(dataset, *, shuffle: bool = True, batch_size: int = 4,
                           seed: int = 0, num_workers: int = 0, process_index: int = 0,
                           process_count: int = 1) -> BatchLoader:
    """Endless shuffled batches of ``dataset``; data-parallel, rank
    ``process_index`` of ``process_count`` reads its stride of the indices
    (:class:`InfiniteRandomSampler`) in batches of ``batch_size`` a rank."""
    del num_workers  # batches are made in the calling thread
    sampler = InfiniteRandomSampler(len(dataset), seed=seed, shuffle=shuffle,
                                    process_index=process_index, process_count=process_count)
    return BatchLoader(dataset, sampler=sampler, batch_size=batch_size, seed=seed)


def _eval_loader(dataset, group_scan: bool) -> BatchLoader:
    if group_scan:
        return BatchLoader(dataset, batch_sampler=ScanBatchSampler(dataset, shuffle=False),
                           infinite=False)
    return BatchLoader(dataset, sampler=range(len(dataset)), batch_size=4, infinite=False)


def create_val_loader(*, test_dataset: SliceDataset, data_name: str,
                      group_scan: bool) -> t.Tuple[BatchLoader, BatchLoader]:
    n_scans = len(test_dataset.get_scan_list())
    n_val = int(n_scans * configure_test_ratio(data_name))
    if n_scans >= 2:
        n_val = min(max(n_val, 1), n_scans - 1)
    val_set, test_set = split_dataset(test_dataset, n_val)
    return _eval_loader(val_set, group_scan), _eval_loader(test_set, group_scan)


def get_data(data_params: t.Mapping, labeled_loader_params: t.Mapping,
             unlabeled_loader_params: t.Mapping, *, root_dir: str,
             pretrain: bool = False, order_num: int = 0):
    """-> (labeled_loader, unlabeled_loader, val_loader, test_loader)."""
    data_name = data_params["name"]
    labeled_scan_num = int(data_params.get("labeled_scan_num", 1))
    tra_set, test_set = create_tra_test_dataset(data_name, root_dir)
    train_scan_num = len(tra_set.get_scan_list())
    if labeled_scan_num > train_scan_num:
        raise RuntimeError(f"labeled_scan_num {labeled_scan_num} > train scans {train_scan_num}")
    lookup_name = "acdc" if data_name.startswith("acdc_") else data_name
    if pretrain:
        label_set, unlabel_set, *_ = split_dataset(tra_set, train_scan_num // 2)
    else:
        try:
            label_set, unlabel_set = split_dataset_with_predefined_filenames(
                tra_set, lookup_name, labeled_scan_nums=labeled_scan_num, order_num=order_num)
        except FileNotFoundError:
            logger.warning("%s: no ordering json, seeded random split", lookup_name)
            label_set, unlabel_set, *_ = split_dataset(tra_set, labeled_scan_num, seed=2)
    if not label_set.get_scan_list():
        raise RuntimeError("empty labeled split")
    labeled_loader = create_infinite_loader(label_set, **labeled_loader_params)
    unlabeled_loader = create_infinite_loader(unlabel_set, **unlabeled_loader_params)
    group_scan = data_name not in ("spleen", "mmwhsct", "mmwhsmr", "prostate_md", "hippocampus")
    val_loader, test_loader = create_val_loader(test_dataset=test_set, data_name=data_name,
                                                group_scan=group_scan)
    return labeled_loader, unlabeled_loader, val_loader, test_loader
