"""The port's t-SNE (plot/) on the CPU, against the JAX package's.

The perplexity search is a 50-step bisection that a float difference can
move by one branch, and a long trajectory is chaotic, so the comparison
goes in steps: ``P`` first (1e-5), then one gradient and its KL (1e-5
relative), then short trajectories (``Tsne`` 10 iterations,
``BarnesHutTsne`` 5, 1e-4); the long run is judged by the JAX test's
separation bar at its own size.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.plot import tsne as jtsne

from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.plot import tsne


def _blobs(n_per=30, d=4, seed=7):
    rng = np.random.RandomState(seed)
    centers = np.array([[0] * d, [10] + [0] * (d - 1),
                        [0, 10] + [0] * (d - 2)], np.float64)
    pts = np.concatenate([c + rng.randn(n_per, d) for c in centers])
    return pts, np.repeat(np.arange(3), n_per)


@pytest.mark.parametrize("perplexity", [5.0, 10.0, 30.0])
def test_p_matrix_equals_jax(perplexity):
    x = _blobs()[0]
    P = Tsne(perplexity=perplexity, device="cpu")._p_matrix(x).numpy()
    jP = np.asarray(jtsne.Tsne(perplexity=perplexity)._p_matrix(x))
    np.testing.assert_allclose(P, jP, rtol=0, atol=1e-5)
    np.testing.assert_allclose(P.sum(), 1.0, rtol=1e-4)


def test_one_gradient_and_kl_equal_jax():
    x = _blobs()[0]
    jP = np.array(jtsne.Tsne(perplexity=10)._p_matrix(x))
    y = np.random.RandomState(3).randn(len(x), 2).astype(np.float32)
    g, kl = tsne._tsne_grad(torch.from_numpy(y), torch.from_numpy(jP))
    jg, jkl = jtsne._tsne_grad(jnp.asarray(y), jnp.asarray(jP))
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-5)


def test_tsne_ten_iterations_equal_jax():
    # at the default rate (200) and exaggeration (12) the early steps
    # multiply a difference ~10x each from the third on: from the same P
    # the two packages' float rounding alone is 1.6e-3 of max |y| apart
    # after 10 iterations, so the trajectory is held at a rate and an
    # exaggeration under which it does not explode
    x = _blobs()[0]
    kw = dict(perplexity=10, max_iter=10, seed=1, learning_rate=10.0,
              early_exaggeration=4.0)
    emb = Tsne(device="cpu", **kw).fit(x)
    t = Tsne(device="cpu", **kw)
    jt = jtsne.Tsne(**kw)
    jemb = jt.fit(x)
    np.testing.assert_allclose(emb, jemb, rtol=0,
                               atol=1e-4 * np.abs(jemb).max())
    t.fit(x)
    np.testing.assert_allclose(t.kl, jt.kl, rtol=1e-4)
    assert t.plot() is t.embedding


def test_barnes_hut_five_iterations_equal_jax():
    x = _blobs(n_per=20, seed=8)[0]
    kw = dict(theta=0.5, perplexity=5, max_iter=5, seed=1)
    emb = BarnesHutTsne(device="cpu", **kw).fit(x)
    jemb = jtsne.BarnesHutTsne(**kw).fit(x)
    assert emb.shape == (60, 2) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, jemb, rtol=0,
                               atol=1e-4 * np.abs(jemb).max())


def test_barnes_hut_theta_zero_is_exact():
    x = _blobs(n_per=10, seed=2)[0]
    emb = BarnesHutTsne(theta=0.0, perplexity=5, max_iter=8, seed=1,
                        device="cpu").fit(x)
    ref = Tsne(perplexity=5, max_iter=8, seed=1, device="cpu").fit(x)
    np.testing.assert_array_equal(emb, ref)


def test_tsne_separates_blobs_like_jax():
    pts, labels = _blobs(n_per=30, seed=7)
    emb = Tsne(perplexity=10, max_iter=250, seed=1, device="cpu").fit(pts)
    assert emb.shape == (90, 2)
    cents = np.stack([emb[labels == c].mean(0) for c in range(3)])
    spread = np.mean([emb[labels == c].std() for c in range(3)])
    min_sep = min(np.linalg.norm(cents[i] - cents[j])
                  for i in range(3) for j in range(i + 1, 3))
    assert min_sep > 2 * spread
