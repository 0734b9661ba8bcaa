"""The port's clustering package (clustering/) on the CPU, against the JAX
package's.

- The four trees (host numpy in both packages) give the JAX trees'
  results exactly.
- ``NearestNeighbors``, euclidean and cosine, over a corpus with
  duplicated points: the JAX indices, ties in the JAX order (the lower
  index first), distances within 1e-5; the tie rule on a row of equal
  distances wider than k.
- ``KMeansClustering`` on blobs: the JAX assignments, centroids and cost
  within 1e-5 relative, the same k-means++ start.
- ``NearestNeighborsServer`` / ``NearestNeighborsClient`` over HTTP answer
  as the in-process index does and as the JAX server does;
  ``use_device=False`` answers through the VPTree; an index that cannot be
  built on its device raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as jkmeans
from deeplearning4j_tpu.clustering import knn as jknn
from deeplearning4j_tpu.clustering import knn_server as jserver
from deeplearning4j_tpu.clustering import trees as jtrees

from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering,
                                                 NearestNeighbors, QuadTree,
                                                 SpTree, VPTree)
from deeplearning4j_tpu_torch.clustering import knn_server as server
from deeplearning4j_tpu_torch.clustering.knn import smallest_k


def _blobs(n_per=50, d=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0] * d, [10] + [0] * (d - 1),
                        [0, 10] + [0] * (d - 2)], np.float64)
    pts = np.concatenate([c + rng.randn(n_per, d) for c in centers])
    return pts, np.repeat(np.arange(3), n_per)


def _with_duplicates(seed=2):
    pts = _blobs(n_per=30, d=6, seed=seed)[0].astype(np.float32)
    # rows 5, 40 and 41 equal row 3; row 70 equals row 60
    pts[[5, 40, 41]] = pts[3]
    pts[70] = pts[60]
    return pts


@pytest.mark.parametrize("kind", ["vp", "vp_cosine", "kd"])
def test_trees_knn_equal_jax(kind):
    pts, _ = _blobs(seed=1)
    make = {"vp": lambda m: m.VPTree(pts),
            "vp_cosine": lambda m: m.VPTree(pts, distance="cosine"),
            "kd": lambda m: m.KDTree(pts)}[kind]
    port = make(__import__("deeplearning4j_tpu_torch.clustering.trees",
                           fromlist=["x"]))
    jax = make(jtrees)
    for q in (pts[7] + 0.01, pts[33] - 0.05, np.zeros(4)):
        pi, pd = port.knn(q, 6)
        ji, jd = jax.knn(q, 6)
        assert list(pi) == list(ji)
        assert np.array_equal(pd, jd)
    assert isinstance(port, (VPTree, KDTree))


def test_quadtree_and_sptree_equal_jax():
    pts2 = _blobs(n_per=30, d=2, seed=6)[0]
    assert QuadTree(pts2).root.count == jtrees.QuadTree(pts2).root.count
    st, jst = SpTree(pts2), jtrees.SpTree(pts2)
    for i in (0, 17, 80):
        for theta in (0.0, 0.5):
            neg, sq = st.compute_non_edge_forces(pts2[i], theta)
            jneg, jsq = jst.compute_non_edge_forces(pts2[i], theta)
            assert np.array_equal(neg, jneg) and sq == jsq


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_nearest_neighbors_equal_jax_with_duplicates(metric):
    pts = _with_duplicates()
    nn = NearestNeighbors(pts, metric=metric, device="cpu")
    jnn = jknn.NearestNeighbors(pts, metric=metric)
    q = pts[[3, 5, 40, 60, 70, 11]]
    idx, d = nn.knn(q, 6)
    jidx, jd = jnn.knn(q, 6)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    # the duplicates of row 3 come back in index order, for every copy
    assert list(idx[0][:4]) == [3, 5, 40, 41] == list(idx[1][:4])
    assert list(idx[3][:2]) == [60, 70] == list(idx[4][:2])
    i1, d1 = nn.knn(pts[11], 3)                  # one query: 1-D results
    assert i1.shape == (3,) and i1[0] == 11
    assert idx.dtype == np.asarray(jidx).dtype


def test_smallest_k_orders_ties_by_index():
    d = torch.tensor([[1.0, 0.5, 0.5, -0.0, 0.0, 0.5, 2.0],
                      [3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
                      [-1.0, -2.0, 0.5, -2.0, 4.0, 0.0, -0.0]])
    idx, v = smallest_k(d, 4)
    assert idx.tolist() == [[3, 4, 1, 2], [0, 1, 2, 3], [1, 3, 0, 5]]
    assert v.tolist() == [[0.0, 0.0, 0.5, 0.5], [3.0] * 4,
                          [-2.0, -2.0, -1.0, 0.0]]


def test_kmeans_equals_jax():
    pts, labels = _blobs(n_per=60, seed=4)
    km = KMeansClustering(k=3, seed=5, device="cpu").apply_to(pts)
    jkm = jkmeans.KMeansClustering(k=3, seed=5).apply_to(pts)
    np.testing.assert_array_equal(km.assignments, jkm.assignments)
    np.testing.assert_allclose(km.centroids, jkm.centroids, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(km.cost, jkm.cost, rtol=1e-5)
    for c in range(3):
        assign = km.assignments[labels == c]
        assert np.bincount(assign).max() / len(assign) > 0.95
    np.testing.assert_array_equal(km.predict(pts[:9]), jkm.predict(pts[:9]))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_kmeans_pp_start_is_the_jax_start_bit_for_bit(k):
    pts = _blobs(n_per=70, d=7, seed=11)[0].astype(np.float32)
    got = KMeansClustering(k=k, seed=3, device="cpu")._init_pp(
        pts, np.random.RandomState(3))
    want = jkmeans.KMeansClustering(k=k, seed=3)._init_pp(
        pts, np.random.RandomState(3))
    assert got.tobytes() == want.tobytes()


def test_kmeans_chunks_give_the_unchunked_step(monkeypatch):
    pts = _blobs(n_per=40, d=5, seed=9)[0]
    whole = KMeansClustering(k=4, seed=1, device="cpu").apply_to(pts)
    from deeplearning4j_tpu_torch.clustering import kmeans
    monkeypatch.setattr(kmeans, "CHUNK_ELEMENTS", 4 * 5 * 7)   # 7 rows
    chunked = KMeansClustering(k=4, seed=1, device="cpu").apply_to(pts)
    np.testing.assert_array_equal(chunked.assignments, whole.assignments)
    np.testing.assert_array_equal(chunked.centroids, whole.centroids)
    assert chunked.iterations == whole.iterations


def test_knn_query_chunks_give_the_whole_matrix(monkeypatch):
    pts = _with_duplicates(seed=4)
    whole = NearestNeighbors(pts, device="cpu").knn(pts[:20], 5)
    from deeplearning4j_tpu_torch.clustering import knn
    monkeypatch.setattr(knn, "CHUNK_ELEMENTS", 3 * len(pts))    # 3 rows
    chunked = NearestNeighbors(pts, device="cpu").knn(pts[:20], 5)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def _serve(pts, **kw):
    return server.NearestNeighborsServer(pts, port=0, **kw).start()


@pytest.mark.parametrize("use_device", [True, False])
def test_server_and_client_answer_as_the_index(use_device):
    pts = _with_duplicates(seed=7)
    kw = dict(use_device=True, device="cpu") if use_device \
        else dict(use_device=False)
    srv = _serve(pts, **kw)
    jsrv = jserver.NearestNeighborsServer(pts, port=0,
                                          use_device=use_device).start()
    try:
        assert isinstance(srv._index,
                          NearestNeighbors if use_device else VPTree)
        cli = server.NearestNeighborsClient(f"http://127.0.0.1:{srv.port}")
        jcli = jserver.NearestNeighborsClient(
            f"http://127.0.0.1:{jsrv.port}")
        res = cli.knn(index=3, k=5)
        assert all(r["index"] != 3 for r in res) and len(res) == 5
        assert [r["index"] for r in res] == [
            r["index"] for r in jcli.knn(index=3, k=5)]
        ids, dists = srv.query(pts[3:4], 6)
        assert [r["index"] for r in res] == [i for i in ids[0] if i != 3][:5]
        got = cli.knn_new(pts[[7, 60]], k=3)
        want = jcli.knn_new(pts[[7, 60]], k=3)
        assert [[r["index"] for r in row] for row in got] == \
            [[r["index"] for r in row] for row in want]
        ids, dists = srv.query(pts[[7, 60]], 3)
        for row, ri, rd in zip(got, ids, dists):
            assert [r["index"] for r in row] == list(ri)
            np.testing.assert_allclose([r["distance"] for r in row], rd,
                                       rtol=0, atol=1e-6)
        with pytest.raises(RuntimeError, match="out of range"):
            cli.knn(index=999, k=1)
    finally:
        srv.stop()
        jsrv.stop()


def test_the_device_index_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = server.NearestNeighborsServer(np.eye(4, dtype=np.float32), port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.start()
    assert srv._index is None and srv._httpd is None


def test_b64_wire_is_the_jax_wire():
    a = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    assert server.ndarray_to_b64(a) == jserver.ndarray_to_b64(a)
    np.testing.assert_array_equal(
        server.ndarray_from_b64(jserver.ndarray_to_b64(a)), a)
