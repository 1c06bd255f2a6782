"""The port's exact t-SNE (contrastyou_tpu_torch/postprocess/tsne.py) held
against scikit-learn's ``TSNE(method="exact")`` and against the JAX
package's ``tsne_embed`` (sklearn's Barnes-Hut) on the CPU.

- P: equal to sklearn's ``_joint_probabilities`` to 1e-6 relative.
- KL(P || Q) and its gradient: equal to ``_kl_divergence`` to 1e-6
  relative.
- The embedding from one initial array: equal to sklearn's to 1e-3
  relative (up to a reflection of an axis; measured: bitwise).
- The PCA initialisation: sklearn's up to the sign of each axis (1e-4; it
  runs its SVD in float32, the port in float64).
- On 3 seeds of clustered 32-d Gaussians (N = 200): the exact KL of the
  port's embedding at most 5% above that of JAX's ``tsne_embed``.
- The scatter PNG, the palette (matplotlib's tab20) and the refused legend.
"""
import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE
from sklearn.manifold._t_sne import _joint_probabilities, _kl_divergence
from sklearn.metrics import pairwise_distances

from contrastyou_tpu.postprocess.tsne import tsne_embed as jtsne_embed
from contrastyou_tpu_torch.data.png import read_png
from contrastyou_tpu_torch.postprocess import tsne as T

torch.set_num_threads(1)


def _clusters(seed, n=200, d=32, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (k, d))
    return (centers[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


@pytest.mark.parametrize("n,perplexity", [(200, 30.0), (40, 30.0), (9, 5.0)])
def test_joint_probabilities_match_sklearn(n, perplexity):
    x = _clusters(n, n=n)
    perp = T.clamp_perplexity(perplexity, n)
    ref = squareform(_joint_probabilities(pairwise_distances(x, squared=True), perp, 0))
    got = T.joint_probabilities(T._sq_distances(torch.tensor(x)), perp).numpy()
    assert _rel(got, ref) <= 1e-6


def test_kl_divergence_and_gradient_match_sklearn():
    x = _clusters(1)
    p = T.joint_probabilities(T._sq_distances(torch.tensor(x)), 30.0)
    y = np.random.default_rng(2).normal(0, 1, (200, 2)).astype(np.float32)
    kl, grad = _kl_divergence(y.ravel(), squareform(p.numpy(), checks=False), 1, 200, 2)
    kl2, grad2 = T.kl_divergence(torch.tensor(y), p)
    assert abs(kl2 - kl) / kl <= 1e-6
    assert _rel(grad2.numpy(), grad.reshape(200, 2)) <= 1e-6


def _up_to_reflection(got, ref):
    """``got`` with each axis flipped where that brings it nearer ``ref``."""
    signs = np.where((got * ref).sum(0) < 0, -1.0, 1.0)
    return got * signs


@pytest.mark.parametrize("seed", [0, 1])
def test_embedding_matches_sklearn_exact(seed):
    x = _clusters(seed)
    perp = T.clamp_perplexity(30.0, len(x))
    init = T.pca_init(torch.tensor(x)).numpy()
    sk = TSNE(method="exact", init=init.copy(), perplexity=perp, random_state=0)
    ref = sk.fit_transform(x)
    res = T.exact_tsne(x, perplexity=perp, init=init, device="cpu")
    assert _rel(_up_to_reflection(res.embedding, ref), ref) <= 1e-3
    assert res.n_iter == sk.n_iter_
    assert abs(res.kl_divergence - sk.kl_divergence_) <= 1e-6 * sk.kl_divergence_


def test_pca_init_matches_sklearn_up_to_sign():
    x = _clusters(3)
    emb = PCA(n_components=2, random_state=0).fit_transform(x).astype(np.float32)
    ref = emb / np.std(emb[:, 0]) * 1e-4
    got = T.pca_init(torch.tensor(x)).numpy()
    assert _rel(_up_to_reflection(got, ref), ref) <= 1e-4


def _exact_kl(x, emb):
    p = T.joint_probabilities(T._sq_distances(torch.tensor(x)), T.clamp_perplexity(30.0, len(x)))
    return T.kl_divergence(torch.tensor(np.asarray(emb, np.float32)), p)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kl_within_5_percent_of_jax_tsne_embed(seed):
    x = _clusters(10 + seed)
    ours = T.tsne_embed(x, device="cpu")
    ref = jtsne_embed(x, seed=0)
    assert ours.shape == ref.shape == (200, 2) and np.isfinite(ours).all()
    assert _exact_kl(x, ours) <= 1.05 * _exact_kl(x, ref)


def test_plot_tsne_writes_a_scatter_png(tmp_path):
    import matplotlib

    np.testing.assert_array_equal(
        T.TAB20, np.rint(np.asarray(matplotlib.colormaps["tab20"].colors) * 255).astype(np.uint8))
    x = _clusters(4, n=60)
    labels = np.arange(60) % 3
    path = T.plot_tsne(x, labels, tmp_path / "sub" / "tsne.png", device="cpu")
    img = read_png(path, rgb=True)
    assert img.shape == (900, 900, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert {tuple(T.TAB20[i]) for i in range(3)} <= colours <= \
        {tuple(T.TAB20[i]) for i in range(3)} | {(255, 255, 255)}
    with pytest.raises(NotImplementedError, match="legend"):
        T.plot_tsne(x, labels, tmp_path / "l.png", show_legend=True, device="cpu")
    assert T.tsne_embed(x[:1], device="cpu").shape == (1, 2)
