"""t-SNE of pooled features and its scatter plot (counterpart of
contrastyou_tpu/postprocess/tsne.py), in torch on the card, with neither
sklearn nor matplotlib.

:func:`exact_tsne` is scikit-learn's ``TSNE(method="exact", init="pca",
learning_rate="auto")`` (``sklearn/manifold/_t_sne.py``) step for step:

- squared Euclidean distances of the features (float64 sums, then float32
  as sklearn casts them), the perplexity clamped as JAX's
  ``tsne_embed`` does (``min(perplexity, max((N - 1) / 3, 1))``);
- the conditional P of each row by sklearn's binary search on its
  precision (100 steps at most, entropy within 1e-5 of ``log(perplexity)``,
  float64), symmetrised and normalised, floored at float64's eps;
- the PCA initialisation (the features centred, their SVD, sklearn's
  ``svd_flip`` signs), scaled so that its first axis has std 1e-4;
- Student-t Q (one degree of freedom), the KL divergence and its gradient
  (``_kl_divergence``: float64 Q, a float32 gradient);
- gradient descent with momentum and sklearn's gains (+0.2 / x0.8, at least
  0.01), ``learning_rate = max(N / 12 / 4, 50)``: 250 iterations at
  momentum 0.5 with P exaggerated 12x, then at momentum 0.8 up to 1000 in
  all; every 50 iterations the error is checked, and a stage stops when the
  gradient norm falls to 1e-7 or the error has not improved for its window
  (250, then 300 iterations). The embedding is float32 and its update
  float64, as NumPy 2 runs sklearn's loop.

JAX's ``tsne_embed`` calls sklearn's default Barnes-Hut approximation; the
exact method costs O(N^2) a step, affordable at the sizes the cluster plot
embeds (a few hundred slices). :func:`plot_tsne` draws the embedding as a
900 x 900 RGB PNG (``data/png.py``): one filled disc a point, coloured by
label in the ``tab20`` palette.
"""
from __future__ import annotations

import math
import typing as t
from pathlib import Path

import numpy as np
import torch

from ..data.png import write_png

__all__ = ["TAB20", "clamp_perplexity", "joint_probabilities", "pca_init", "kl_divergence",
           "TSNEResult", "exact_tsne", "tsne_embed", "plot_tsne"]

#: matplotlib's ``tab20`` colours as 8-bit RGB
TAB20 = np.array([
    (31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120), (44, 160, 44),
    (152, 223, 138), (214, 39, 40), (255, 152, 150), (148, 103, 189), (197, 176, 213),
    (140, 86, 75), (196, 156, 148), (227, 119, 194), (247, 182, 210), (127, 127, 127),
    (199, 199, 199), (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229)],
    np.uint8)
#: sklearn's constants
MACHINE_EPSILON = float(np.finfo(np.double).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
MAX_ITER = 1000
PERPLEXITY_STEPS = 100
PERPLEXITY_TOLERANCE = 1e-5


def _device(features, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(features, torch.Tensor):
        return features.device
    if not torch.cuda.is_available():
        raise RuntimeError("t-SNE runs on the CUDA card; pass device='cpu' for the CPU")
    return torch.device("cuda")


def clamp_perplexity(perplexity: float, n: int) -> float:
    """JAX ``tsne_embed``'s clamp: ``min(perplexity, max((n - 1) / 3, 1))``."""
    return min(float(perplexity), max((n - 1) / 3.0, 1.0))


def _sq_distances(x: torch.Tensor) -> torch.Tensor:
    """[N, N] squared Euclidean distances in float64, as float32."""
    x = x.double()
    return ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1).float()


def joint_probabilities(distances: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn ``_joint_probabilities`` on [N, N] squared distances -> the
    symmetric joint P [N, N] (float64; zero diagonal, off-diagonal entries
    at least eps)."""
    d = distances.float().double()
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    cond = torch.zeros_like(d)
    for _ in range(PERPLEXITY_STEPS):
        p = torch.where(off, torch.exp(-d * beta[:, None]), torch.zeros_like(d))
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        entropy = torch.log(s) + beta * (d * p).sum(1)
        diff = entropy - desired
        cond = torch.where(active[:, None], p, cond)
        done = diff.abs() <= PERPLEXITY_TOLERANCE
        move = active & ~done
        up = move & (diff > 0)
        down = move & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0),
                           beta)
        active = move
        if not bool(active.any()):
            break
    joint = cond + cond.T
    joint = joint / torch.clamp(joint[off].sum(), min=MACHINE_EPSILON)
    return torch.where(off, torch.clamp(joint, min=MACHINE_EPSILON), torch.zeros_like(joint))


def pca_init(features: torch.Tensor) -> torch.Tensor:
    """sklearn's PCA initialisation: the first two principal components
    (signs by ``svd_flip`` on the components), float32, scaled so that the
    first has a (population) std of 1e-4."""
    x = features.double()
    x = x - x.mean(0, keepdim=True)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    signs = torch.sign(vt[torch.arange(vt.shape[0]), vt.abs().argmax(1)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    emb = (u[:, :2] * s[:2] * signs[:2]).float()
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def kl_divergence(y: torch.Tensor, joint: torch.Tensor, *, compute_error: bool = True
                  ) -> t.Tuple[float, torch.Tensor]:
    """sklearn ``_kl_divergence`` with one degree of freedom: (KL(P || Q)
    in float64, or nan without ``compute_error``; the float32 gradient
    [N, 2])."""
    yd = y.double()
    dist = 1.0 / (1.0 + ((yd[:, None, :] - yd[None, :, :]) ** 2).sum(-1))
    n = y.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=y.device)
    dist = torch.where(off, dist, torch.zeros_like(dist))
    q = torch.clamp(dist / dist.sum(), min=MACHINE_EPSILON)
    kl = math.nan
    if compute_error:
        kl = float(torch.where(off, joint * torch.log(torch.clamp(joint, min=MACHINE_EPSILON)
                                                      / q), torch.zeros_like(q)).sum())
    pqd = torch.where(off, (joint - q) * dist, torch.zeros_like(q))
    diff = (y[:, None, :] - y[None, :, :]).double()
    grad = (pqd[:, :, None] * diff).sum(1).float() * 4.0
    return kl, grad


def _descent(y, joint, *, it, max_iter, momentum, learning_rate, n_iter_without_progress):
    """sklearn ``_gradient_descent`` from iteration ``it`` (a fresh update
    and fresh gains, as each of its calls) -> (y, error, last iteration)."""
    update = torch.zeros(y.shape, dtype=torch.float64, device=y.device)
    gains = torch.ones_like(y)
    error, best_error, best_iter = math.inf, math.inf, it
    i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = kl_divergence(y, joint, compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.double()
        y = (y.double() + update).float()
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


class TSNEResult(t.NamedTuple):
    embedding: np.ndarray     # [N, 2] float32
    kl_divergence: float      # KL(P || Q) of the embedding (exact)
    n_iter: int               # the last iteration run (sklearn's ``n_iter_``)


def exact_tsne(features, *, perplexity: float = 30.0, init=None, device=None,
               max_iter: int = MAX_ITER) -> TSNEResult:
    """Exact t-SNE of [N, d] ``features`` into 2-D (module docstring). ``init``
    replaces the PCA initialisation with a given [N, 2] array."""
    dev = _device(features, device)
    x = torch.as_tensor(np.asarray(features, np.float32) if not isinstance(
        features, torch.Tensor) else features, device=dev).float()
    n = x.shape[0]
    if n < 2:
        return TSNEResult(np.zeros((n, 2), np.float32), 0.0, 0)
    joint = joint_probabilities(_sq_distances(x), clamp_perplexity(perplexity, n))
    y = (pca_init(x) if init is None
         else torch.as_tensor(np.asarray(init, np.float32), device=dev))
    learning_rate = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    y, kl, it = _descent(y, joint * EARLY_EXAGGERATION, it=0, max_iter=EXPLORATION_ITER,
                         momentum=0.5, learning_rate=learning_rate,
                         n_iter_without_progress=EXPLORATION_ITER)
    if it < EXPLORATION_ITER or max_iter - EXPLORATION_ITER > 0:
        y, kl, it = _descent(y, joint, it=it + 1, max_iter=max_iter, momentum=0.8,
                             learning_rate=learning_rate,
                             n_iter_without_progress=N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(y.cpu().numpy(), kl, it)


def tsne_embed(features, *, perplexity: float = 30.0, seed: int = 0,
               device=None) -> np.ndarray:
    """[N, d] -> [N, 2] exact t-SNE embedding (JAX ``tsne_embed``'s
    signature; ``seed`` is kept for it: the PCA initialisation draws
    nothing). On the card unless ``device`` (or a CPU tensor) says
    otherwise."""
    del seed
    return exact_tsne(features, perplexity=perplexity, device=device).embedding


def scatter_image(points: np.ndarray, labels: np.ndarray, *, size: int = 900,
                  radius: int = 5, margin: int = 30) -> np.ndarray:
    """[size, size, 3] uint8: white, one filled disc of ``radius`` a point,
    the points fitted into the square inside ``margin``, each label's
    points in its tab20 colour (labels in sorted order, later on top)."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = np.asarray(points, np.float64)
    if len(pts) == 0:
        return img
    lo, hi = pts.min(0), pts.max(0)
    scale = (size - 1 - 2 * margin) / max(float((hi - lo).max()), 1e-12)
    pix = np.rint((pts - lo) * scale + margin).astype(np.int64)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = yy ** 2 + xx ** 2 <= radius ** 2
    dy, dx = yy[disc], xx[disc]
    labels = np.asarray(labels)
    for k, lab in enumerate(np.unique(labels)):
        sel = pix[labels == lab]
        # the y axis points up, as in a plot
        rows = (size - 1 - sel[:, 1])[:, None] + dy[None]
        cols = sel[:, 0][:, None] + dx[None]
        ok = (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
        img[rows[ok], cols[ok]] = TAB20[k % len(TAB20)]
    return img


def plot_tsne(features, labels, save_path, show_legend: bool = False, *,
              device=None) -> str:
    """The t-SNE of ``features`` (:func:`tsne_embed`) as a 900 x 900 RGB PNG
    at ``save_path``, coloured by ``labels``. ``show_legend`` needs text
    rendering, which the port does not have: it raises."""
    if show_legend:
        raise NotImplementedError("plot_tsne(show_legend=True) needs text rendering "
                                  "(matplotlib), which the port does not use")
    emb = tsne_embed(features, device=device)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, scatter_image(emb, labels))
    return str(save_path)
