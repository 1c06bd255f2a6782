"""The port's augmentation (contrastyou_tpu_torch/ops/affine.py, ops/intensity.py)
held against the JAX package's default gather path with identical draws: the
GeoParams, gammas, jitter factors and cutout corners are drawn by JAX from its
keys and handed to the port as tensors.

Tolerances: nearest-neighbour warps are compared exactly (both round the
same f32 sampling coordinates half to even); the gamma-corrected image at
rtol 1e-6 (the two ``pow`` implementations differ by one f32 ulp on ~1.5% of
pixels, far below the gap between neighbouring pixels); the bilinear warp at
atol 3e-5 (see BILINEAR_ATOL); the other intensity maps at rtol 1e-5 / atol
1e-6 (f32 arithmetic in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.ops import affine as jaff
from contrastyou_tpu.ops import intensity as jint
from contrastyou_tpu_torch.ops import affine as aff
from contrastyou_tpu_torch.ops import intensity as inten
from torch_parity import close, n, t

torch.set_num_threads(1)

B, H, W = 4, 24, 24
#: bilinear weights are f32 differences of pixel coordinates up to W (ulp
#: ~2e-6), times values up to ~4
BILINEAR_ATOL = 3e-5


@pytest.fixture(autouse=True)
def _gather_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")


def _geo(seed=0):
    jgeo = jaff.sample_geo_params(jax.random.PRNGKey(seed), B)
    tgeo = aff.GeoParams(*(torch.tensor(np.asarray(v)) for v in jgeo))
    return jgeo, tgeo


def _images(c=1, seed=0):
    return np.random.default_rng(seed).random((B, H, W, c)).astype(np.float32)


def test_affine_matrices_match():
    jgeo, tgeo = _geo()
    close(aff.affine_matrices(tgeo), jaff.affine_matrices(jgeo), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_image_matches(seed):
    """Gamma then nearest warp + mirror, the semi step's T(x)."""
    jgeo, tgeo = _geo(seed)
    x = _images(seed=seed)
    k = jax.random.PRNGKey(100 + seed)
    gammas = jax.random.uniform(k, (B, 1, 1, 1), minval=0.5, maxval=2.0)
    ref = jaff.transform_image(jnp.asarray(x), jgeo, k)
    got = aff.transform_image(t(x), tgeo, t(gammas).reshape(B))
    close(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("order", [0, 1])
def test_transform_logits_matches(order):
    """T(f(x)) on a 4-class logit map, nearest (the step) and bilinear."""
    jgeo, tgeo = _geo(3)
    x = np.random.default_rng(3).standard_normal((B, H, W, 4)).astype(np.float32)
    ref = jaff.transform_logits(jnp.asarray(x), jgeo, order=order)
    got = aff.transform_logits(t(x), tgeo, order=order)
    if order == 0:
        np.testing.assert_array_equal(n(got), n(ref))
    else:
        close(got, ref, rtol=1e-5, atol=BILINEAR_ATOL)


def test_flips_match():
    jgeo, tgeo = _geo(4)
    x = _images(c=2, seed=4)
    np.testing.assert_array_equal(n(aff.apply_flips(t(x), tgeo)),
                                  n(jaff.apply_flips(jnp.asarray(x), jgeo)))


def test_intensity_ops_match():
    x = _images(seed=5)
    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(key, x.shape)
    close(inten.gaussian_noise(t(x), t(noise)), jint.gaussian_noise(jnp.asarray(x), key),
          rtol=1e-6, atol=1e-6)
    kb, kc = jax.random.split(key)
    b = jax.random.uniform(kb, (B, 1, 1, 1), minval=0.8, maxval=1.2)
    c = jax.random.uniform(kc, (B, 1, 1, 1), minval=0.8, maxval=1.2)
    close(inten.color_jitter(t(x), t(b).reshape(B), t(c).reshape(B)),
          jint.color_jitter(jnp.asarray(x), key), rtol=1e-5, atol=1e-6)
    kh, kw = jax.random.split(key)
    ys = jax.random.randint(kh, (B,), 0, H - 8)
    xs = jax.random.randint(kw, (B,), 0, W - 8)
    got = inten.random_cutout(t(x), torch.tensor(np.asarray(ys)),
                              torch.tensor(np.asarray(xs)), size=(8, 8))
    np.testing.assert_array_equal(
        n(got), n(jint.random_cutout(jnp.asarray(x), key, size=(8, 8))))


def test_sampled_draws_follow_the_reference_ranges():
    g = torch.Generator().manual_seed(0)
    geo = aff.sample_geo_params(g, 4096)
    gam = aff.sample_gammas(g, 4096)
    assert 0.8 <= float(geo.scale.min()) and float(geo.scale.max()) <= 1.3
    assert float(geo.angle.abs().max()) <= np.pi / 4 + 1e-6
    assert float(geo.tx.abs().max()) <= 0.2 + 1e-6
    assert not bool((geo.flip_h & geo.flip_w).any())
    mirrored = float((geo.flip_h | geo.flip_w).float().mean())
    assert abs(mirrored - 0.9) < 0.03
    assert 0.5 <= float(gam.min()) and float(gam.max()) <= 2.0
