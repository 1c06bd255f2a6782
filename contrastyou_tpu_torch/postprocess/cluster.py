"""Hungarian matching of cluster ids to a reference segmentation
(counterpart of contrastyou_tpu/postprocess/cluster.py), on numpy and
scipy's ``linear_sum_assignment``. The vote matrix is one ``bincount`` of
``cluster * k + reference``: the counts of JAX's k x k mask passes."""
from __future__ import annotations

import typing as t

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["vote_matrix", "hungarian_match", "cluster_alignment"]


def vote_matrix(cluster: np.ndarray, reference: np.ndarray, num_clusters: int) -> np.ndarray:
    """votes[c, r]: the positions where ``cluster`` is c and ``reference`` r
    (ids at or above ``num_clusters``, and negative ids, are not counted)."""
    c = np.asarray(cluster).reshape(-1).astype(np.int64)
    r = np.asarray(reference).reshape(-1).astype(np.int64)
    keep = (c >= 0) & (c < num_clusters) & (r >= 0) & (r < num_clusters)
    flat = c[keep] * num_clusters + r[keep]
    return np.bincount(flat, minlength=num_clusters * num_clusters).reshape(
        num_clusters, num_clusters)


def hungarian_match(cluster: np.ndarray, reference: np.ndarray,
                    num_clusters: int) -> t.Dict[int, int]:
    """The one-to-one map cluster id -> reference id of largest overlap."""
    rows, cols = linear_sum_assignment(-vote_matrix(cluster, reference, num_clusters))
    return {int(c): int(r) for c, r in zip(rows, cols)}


def cluster_alignment(cluster: np.ndarray, reference: np.ndarray,
                      num_clusters: t.Optional[int] = None) -> np.ndarray:
    """``cluster`` relabelled by :func:`hungarian_match` (ids it does not map
    become 0)."""
    cluster = np.asarray(cluster)
    k = num_clusters or int(max(cluster.max(), np.asarray(reference).max()) + 1)
    mapping = hungarian_match(cluster, reference, k)
    lut = np.zeros(k, cluster.dtype)
    for src, dst in mapping.items():
        lut[src] = dst
    out = np.zeros_like(cluster)
    inside = (cluster >= 0) & (cluster < k)
    out[inside] = lut[cluster[inside]]
    return out
