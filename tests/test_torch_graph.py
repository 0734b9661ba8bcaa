"""The port's graph package (graph API, random walks, GraphHuffman,
DeepWalk, node2vec) held against the JAX package on the CPU.

Walks, Huffman codes and initial tables come from the JAX package's numpy
draws in its order and are bitwise equal; DeepWalk draws nothing on the
device, so a fit trains on the same batches and its tables stay within
atol 2e-6 of the JAX tables (largest seen 5.7e-7 on tables of scale 0.44,
float32 scatter-adds summed in another order).
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as J
from deeplearning4j_tpu.graph import api as japi
from deeplearning4j_tpu.graph.walks import generate_walks_batch as j_walks

import deeplearning4j_tpu_torch.graph as P
from deeplearning4j_tpu_torch.graph import api as papi
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec, \
    Node2VecWalkIterator
from deeplearning4j_tpu_torch.graph.walks import \
    generate_walks_batch as p_walks

DW_ATOL = 2e-6


def _ring(G, n=10):
    g = G.Graph(n)
    for i in range(n):
        g.add_edge(i, (i + 1) % n)
    return g


def _cliques(G, n=12):
    """The JAX suite's two 6-cliques joined by one bridge edge."""
    g = G.Graph(n)
    for grp in (range(0, n // 2), range(n // 2, n)):
        grp = list(grp)
        for i in grp:
            for j in grp:
                if i < j:
                    g.add_edge(i, j)
    g.add_edge(n // 2 - 1, n // 2)
    return g


def _weighted(G):
    g = G.Graph(5)
    for a, b, w in ((0, 1, 3.0), (0, 2, 1.0), (1, 2, 0.5), (2, 3, 2.0),
                    (3, 4, 1.0), (4, 0, 4.0)):
        g.add_edge(a, b, weight=w)
    return g


@pytest.mark.parametrize("make", [_ring, _cliques, _weighted])
def test_graph_structure_and_padded_view_equal(make):
    j, p = make(J), make(P)
    assert j.num_vertices() == p.num_vertices()
    np.testing.assert_array_equal(j.degrees(), p.degrees())
    for v in range(j.num_vertices()):
        assert j.neighbors(v) == p.neighbors(v)
        assert j.neighbor_weights(v) == p.neighbor_weights(v)
    for a, b in zip(j.padded_adjacency(), p.padded_adjacency()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_vectorized_walks_bitwise(weighted):
    j, p = _weighted(J), _weighted(P)
    a = j_walks(j, np.arange(5), 7, np.random.default_rng(3),
                weighted=weighted)
    b = p_walks(p, np.arange(5), 7, np.random.default_rng(3),
                weighted=weighted)
    np.testing.assert_array_equal(a, b)
    for w in b:
        for x, y in zip(w, w[1:]):
            assert int(y) in p.neighbors(int(x))


def test_walk_iterators_bitwise():
    j, p = _weighted(J), _weighted(P)
    assert list(J.RandomWalkIterator(j, 6, seed=2)) == \
        list(P.RandomWalkIterator(p, 6, seed=2))
    assert list(J.WeightedRandomWalkIterator(j, 6, seed=2)) == \
        list(P.WeightedRandomWalkIterator(p, 6, seed=2))
    ji = J.RandomWalkGraphIteratorProvider(j, 4, seed=1) \
        .get_graph_walk_iterators(3)
    pi = P.RandomWalkGraphIteratorProvider(p, 4, seed=1) \
        .get_graph_walk_iterators(3)
    assert [list(i) for i in ji] == [list(i) for i in pi]


def test_disconnected_vertex_handling():
    g = P.Graph(3)
    g.add_edge(0, 1)
    it = P.RandomWalkIterator(g, walk_length=3, seed=0, first_vertex=2,
                              last_vertex=3)
    assert next(it) == [2, 2, 2, 2]
    it2 = P.RandomWalkIterator(
        g, walk_length=3, seed=0,
        mode=P.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED, first_vertex=2,
        last_vertex=3)
    with pytest.raises(P.NoEdgesException):
        next(it2)
    with pytest.raises(P.NoEdgesException):
        d = P.Graph(3)
        d.add_edge(0, 1, directed=True)
        p_walks(d, np.array([0]), 3, np.random.default_rng(0),
                mode=P.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)


@pytest.mark.parametrize("degrees", [[12, 3, 6, 1, 2, 7, 8], [5],
                                     list(range(1, 20))])
def test_graph_huffman_equal(degrees):
    j = J.GraphHuffman(len(degrees)).build_tree(degrees)
    p = P.GraphHuffman(len(degrees)).build_tree(degrees)
    for v in range(len(degrees)):
        assert j.get_code(v) == p.get_code(v)
        assert j.get_code_length(v) == p.get_code_length(v)
        assert j.get_path_inner_node(v) == p.get_path_inner_node(v)
    for a, b in zip(j.padded(), p.padded()):
        np.testing.assert_array_equal(a, b)


def _deepwalks(**kw):
    j = J.DeepWalk(**kw)
    p = P.DeepWalk(device="cpu", **kw)
    return j, p


def test_deepwalk_initial_tables_bitwise():
    j, p = _deepwalks(vector_size=16, seed=7)
    j.initialize(_cliques(J))
    p.initialize(_cliques(P))
    np.testing.assert_array_equal(np.asarray(j.syn0), p.syn0.numpy())
    np.testing.assert_array_equal(np.asarray(j.syn1), p.syn1.numpy())
    for a, b in zip((j._pts, j._cds, j._msk), (p._pts, p._cds, p._msk)):
        np.testing.assert_array_equal(a, b)


def test_deepwalk_fit_matches_jax_and_learns_communities():
    j, p = _deepwalks(vector_size=16, window_size=3, learning_rate=0.1,
                      seed=7)
    j.walks_per_vertex = p.walks_per_vertex = 5
    j.fit(_cliques(J), walk_length=10, epochs=20)
    p.fit(_cliques(P), walk_length=10, epochs=20)
    np.testing.assert_allclose(p.syn0.numpy(), np.asarray(j.syn0),
                               rtol=1e-4, atol=DW_ATOL)
    np.testing.assert_allclose(p.syn1.numpy(), np.asarray(j.syn1),
                               rtol=1e-4, atol=DW_ATOL)
    same = np.mean([p.similarity(0, k) for k in range(1, 6)])
    cross = np.mean([p.similarity(0, k) for k in range(6, 12)])
    assert same > cross
    assert list(p.vertices_nearest(0, 3)) == list(j.vertices_nearest(0, 3))


def test_deepwalk_builder_and_fit_walks_match_jax():
    jd = (J.DeepWalk.Builder().vector_size(8).window_size(2)
          .learning_rate(0.05).seed(3).build())
    pd = (P.DeepWalk.Builder().vector_size(8).window_size(2)
          .learning_rate(0.05).seed(3).device("cpu").build())
    jd.initialize(_ring(J))
    pd.initialize(_ring(P))
    walks = j_walks(_ring(J), np.arange(10), 6, np.random.default_rng(1))
    jd.fit_walks(walks)
    pd.fit_walks(walks)
    np.testing.assert_allclose(pd.syn0.numpy(), np.asarray(jd.syn0),
                               rtol=1e-4, atol=DW_ATOL)
    with pytest.raises(RuntimeError):
        P.DeepWalk(device="cpu").fit_walks(walks)


def test_deepwalk_save_load_round_trip_across_packages(tmp_path):
    p = P.DeepWalk(vector_size=8, seed=3, device="cpu").initialize(_ring(P))
    p.fit(_ring(P), walk_length=5)
    path = str(tmp_path / "dw")
    p.save(path)
    back = P.DeepWalk.load(path, device="cpu")
    np.testing.assert_array_equal(back.get_vertex_vector(2),
                                  p.get_vertex_vector(2))
    assert back.num_vertices() == 10
    back.fit(_ring(P), walk_length=5)
    back.fit_walks(np.array([[0, 1, 2, 3]], np.int32))
    # a file either package writes loads in the other
    j = J.DeepWalk.load(path)
    np.testing.assert_array_equal(np.asarray(j.syn0), p.syn0.numpy())
    j.save(str(tmp_path / "jdw"))
    q = P.DeepWalk.load(str(tmp_path / "jdw"), device="cpu")
    np.testing.assert_array_equal(q.syn1.numpy(), np.asarray(j.syn1))


def test_node2vec_walks_equal_and_fit_trains():
    from deeplearning4j_tpu.graph.node2vec import \
        Node2VecWalkIterator as JIter
    jw = list(JIter(_cliques(J), 8, p=0.5, q=2.0, seed=4))
    pw = list(Node2VecWalkIterator(_cliques(P), 8, p=0.5, q=2.0, seed=4))
    assert jw == pw
    n2v = (Node2Vec.Builder().vector_size(8).window_size(3).seed(5)
           .p(0.5).q(2.0).device("cpu").build())
    n2v.initialize(_cliques(P))
    before = n2v.syn0.clone()
    n2v.fit(_cliques(P), walk_length=8, epochs=2)
    assert not torch.equal(before, n2v.syn0)
    assert torch.isfinite(n2v.syn0).all()


def test_edge_list_loader(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("# comment\n// another\n0,1\n1,2,5.0\n2,0\n")
    for directed in (False, True):
        j = japi.load_edge_list(str(path), 3, weighted=True,
                                directed=directed)
        p = papi.load_edge_list(str(path), 3, weighted=True,
                                directed=directed)
        for v in range(3):
            assert j.neighbors(v) == p.neighbors(v)
            assert j.neighbor_weights(v) == p.neighbor_weights(v)
    assert 5.0 in p.neighbor_weights(1)
