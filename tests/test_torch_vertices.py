"""The port's graph vertices held against the JAX package's on the CPU.

The thirteen vertices this slice ports (MergeVertex to PoolHelperVertex)
and ElementWiseVertex: each vertex alone on random inputs (its output and
its output type, read back from the JAX vertex's JSON), and one small
graph per vertex, built in the JAX package and read by the port from its
JSON with the JAX graph's initial parameters, through ``output`` and one
``fit`` step (Sgd 0.1): loss to 1e-6 relative, outputs and parameters to
float32 rtol 1e-5 / atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import graph_conf as jgc
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd

from deeplearning4j_tpu_torch import ComputationGraph, params_from_numpy
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              InputType)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphVertex

RTOL, ATOL, LOSS_RTOL = 1e-5, 1e-6, 1e-6
B, T = 4, 5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (id, vertex, inputs, their input types)
VERTICES = [
    ("merge_ff", jgc.MergeVertex(), [_x(B, 3), _x(B, 2, seed=1)],
     [JIT.feed_forward(3), JIT.feed_forward(2)]),
    ("merge_cnn", jgc.MergeVertex(), [_x(B, 2, 3, 2), _x(B, 2, 3, 1, seed=1)],
     [JIT.convolutional(2, 3, 2), JIT.convolutional(2, 3, 1)]),
    ("merge_rnn", jgc.MergeVertex(), [_x(B, T, 2), _x(B, T, 3, seed=1)],
     [JIT.recurrent(2, T), JIT.recurrent(3, T)]),
    ("elementwise_max", jgc.ElementWiseVertex(op="max"),
     [_x(B, 3), _x(B, 3, seed=1), _x(B, 3, seed=2)], [JIT.feed_forward(3)] * 3),
    ("elementwise_average", jgc.ElementWiseVertex(op="average"),
     [_x(B, 3), _x(B, 3, seed=1)], [JIT.feed_forward(3)] * 2),
    ("subset", jgc.SubsetVertex(from_idx=1, to_idx=3), [_x(B, 5)],
     [JIT.feed_forward(5)]),
    ("subset_rnn", jgc.SubsetVertex(from_idx=0, to_idx=1), [_x(B, T, 3)],
     [JIT.recurrent(3, T)]),
    ("stack", jgc.StackVertex(), [_x(B, 3), _x(B, 3, seed=1)],
     [JIT.feed_forward(3)] * 2),
    ("unstack", jgc.UnstackVertex(from_idx=1, stack_size=2), [_x(B, 3)],
     [JIT.feed_forward(3)]),
    ("scale", jgc.ScaleVertex(scale=-2.5), [_x(B, 3)], [JIT.feed_forward(3)]),
    ("shift", jgc.ShiftVertex(shift=0.75), [_x(B, 3)], [JIT.feed_forward(3)]),
    ("l2_normalize", jgc.L2NormalizeVertex(), [_x(B, 4)],
     [JIT.feed_forward(4)]),
    ("reshape", jgc.ReshapeVertex(shape=(2, 3)), [_x(B, 6)],
     [JIT.feed_forward(6)]),
    ("last_time_step", jgc.LastTimeStepVertex(), [_x(B, T, 3)],
     [JIT.recurrent(3, T)]),
    ("duplicate_to_time_series",
     jgc.DuplicateToTimeSeriesVertex(ref_input="seq"),
     [_x(B, 3), _x(B, T, 2, seed=1)], [JIT.feed_forward(3),
                                        JIT.recurrent(2, T)]),
    ("l2", jgc.L2Vertex(), [_x(B, 2, 3), _x(B, 2, 3, seed=1)],
     [JIT.convolutional(2, 3, 1)] * 2),
    ("preprocessor_cnn_to_ff", jgc.PreprocessorVertex("cnn_to_ff"),
     [_x(B, 2, 3, 2)], [JIT.convolutional(2, 3, 2)]),
    ("preprocessor_ff_to_cnn",
     jgc.PreprocessorVertex("ff_to_cnn", height=2, width=3, channels=2),
     [_x(B, 12)], [JIT.feed_forward(12)]),
    ("preprocessor_rnn_to_ff", jgc.PreprocessorVertex("rnn_to_ff"),
     [_x(B, T, 3)], [JIT.recurrent(3, T)]),
    ("preprocessor_ff_to_rnn", jgc.PreprocessorVertex("ff_to_rnn", tsteps=2),
     [_x(B, 3)], [JIT.feed_forward(3)]),
    ("pool_helper", jgc.PoolHelperVertex(), [_x(B, 4, 5, 2)],
     [JIT.convolutional(4, 5, 2)]),
]


@pytest.mark.parametrize("case,jv,xs,types", VERTICES,
                         ids=[v[0] for v in VERTICES])
def test_vertex_matches_jax(case, jv, xs, types):
    v = GraphVertex.from_dict(jv.to_dict())
    assert v.to_dict() == jv.to_dict()
    got = v.apply([torch.from_numpy(x) for x in xs])
    want = np.asarray(jv.apply([jax.numpy.asarray(x) for x in xs]))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert v.output_type([InputType.from_dict(t.to_dict())
                          for t in types]).to_dict() \
        == jv.output_type(types).to_dict()


def test_last_time_step_vertex_reads_the_mask():
    """The last set entry of each row (gapped rows, an all-zero row takes
    step 0), as the JAX vertex."""
    m = np.array([[1, 1, 0, 1, 0], [1, 0, 0, 0, 0], [0] * 5, [1] * 5],
                 np.float32)
    x = _x(B, T, 3)
    jv = jgc.LastTimeStepVertex(mask_input="in")
    v = GraphVertex.from_dict(jv.to_dict())
    np.testing.assert_array_equal(
        v.apply([torch.from_numpy(x)], mask=torch.from_numpy(m)).numpy(),
        np.asarray(jv.apply([jax.numpy.asarray(x)],
                            mask=jax.numpy.asarray(m))))


def _dense(n, act="tanh"):
    return jl.DenseLayer(n_out=n, activation=act)


def _out(n, **kw):
    return jl.OutputLayer(n_out=n, activation="softmax", loss="mcxent", **kw)


def _graph(case):
    """(JAX graph builder with its layers and vertex, feature arrays,
    label arrays, feature masks or None) for one vertex."""
    g = (JaxNNC.builder().seed(5).updater(JaxSgd(0.1)).weight_init("xavier")
         .graph_builder())
    r = np.random.RandomState(len(case))
    eye = np.eye(3, dtype=np.float32)

    def lab(n, t=None):
        shape = (n,) if t is None else (n, t)
        return eye[r.randint(0, 3, shape)]
    masks = None
    if case in ("merge", "stack", "elementwise", "l2"):
        g.add_inputs("a", "b").set_input_types(JIT.feed_forward(4),
                                               JIT.feed_forward(4))
        g.add_layer("da", _dense(3), "a").add_layer("db", _dense(3), "b")
        vertex = {"merge": jgc.MergeVertex(), "stack": jgc.StackVertex(),
                  "elementwise": jgc.ElementWiseVertex(op="product"),
                  "l2": jgc.L2Vertex()}[case]
        g.add_vertex("v", vertex, "da", "db")
        g.add_layer("out", _out(3), "v")
        xs = [_x(B, 4, seed=1), _x(B, 4, seed=2)]
        ys = [lab(2 * B if case == "stack" else B)]
    elif case in ("subset", "unstack", "scale", "shift", "l2_normalize",
                  "reshape"):
        g.add_inputs("in").set_input_types(JIT.feed_forward(4))
        g.add_layer("d", _dense(6), "in")
        vertex = {"subset": jgc.SubsetVertex(from_idx=1, to_idx=4),
                  "unstack": jgc.UnstackVertex(from_idx=1, stack_size=2),
                  "scale": jgc.ScaleVertex(scale=0.5),
                  "shift": jgc.ShiftVertex(shift=-0.25),
                  "l2_normalize": jgc.L2NormalizeVertex(),
                  "reshape": jgc.ReshapeVertex(shape=(2, 3))}[case]
        g.add_vertex("v", vertex, "d")
        g.add_layer("out", _out(3), "v")
        xs = [_x(B, 4, seed=3)]
        ys = [lab(B // 2 if case == "unstack" else B)]
    elif case == "last_time_step":
        g.add_inputs("in").set_input_types(JIT.recurrent(3, T))
        g.add_layer("d", _dense(4), "in")
        g.add_vertex("v", jgc.LastTimeStepVertex(mask_input="in"), "d")
        g.add_layer("out", _out(3), "v")
        xs = [_x(B, T, 3, seed=4)]
        ys = [lab(B)]
        m = np.ones((B, T), np.float32)
        m[0, 3:] = 0.0
        m[2, 1] = 0.0
        masks = [m]
    elif case == "duplicate_to_time_series":
        g.add_inputs("vec", "seq").set_input_types(JIT.feed_forward(3),
                                                   JIT.recurrent(2, T))
        g.add_layer("d", _dense(4), "vec")
        g.add_vertex("v", jgc.DuplicateToTimeSeriesVertex(ref_input="seq"),
                     "d")
        g.add_vertex("m", jgc.MergeVertex(), "v", "seq")
        g.add_layer("out", jl.RnnOutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "m")
        xs = [_x(B, 3, seed=5), _x(B, T, 2, seed=6)]
        ys = [lab(B, T)]
    elif case in ("preprocessor", "pool_helper"):
        g.add_inputs("in").set_input_types(JIT.convolutional(5, 4, 2))
        g.add_layer("c", jl.ConvolutionLayer(n_out=3, kernel_size=2,
                                             activation="relu"), "in")
        if case == "preprocessor":
            g.add_vertex("v", jgc.PreprocessorVertex("cnn_to_ff"), "c")
            g.add_layer("out", _out(3), "v")
        else:
            g.add_vertex("v", jgc.PoolHelperVertex(), "c")
            g.add_layer("p", jl.GlobalPoolingLayer(pooling_type="avg"), "v")
            g.add_layer("out", _out(3), "p")
        xs = [_x(B, 5, 4, 2, seed=7)]
        ys = [lab(B)]
    else:
        raise ValueError(case)
    return g.set_outputs("out"), xs, ys, masks


GRAPHS = ["merge", "elementwise", "subset", "stack", "unstack", "scale",
          "shift", "l2_normalize", "reshape", "last_time_step",
          "duplicate_to_time_series", "l2", "preprocessor", "pool_helper"]


@pytest.mark.parametrize("case", GRAPHS)
def test_graph_with_the_vertex_matches_jax(case):
    g, xs, ys, masks = _graph(case)
    jnet = JaxCG(g.build()).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, device="cpu").set_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    # output (no mask: the graphs' output reads none in either package);
    # the JAX graph's exact-shape program, as its bucketed engine slices a
    # multi-input graph's outputs to the inputs' rows (StackVertex doubles
    # them)
    jo = jnet.output(*xs, bucketed=False)
    o = net.output(*xs)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    # one fit step
    jnet.fit(JaxMDS(xs, ys, masks, None))
    net.fit(MultiDataSet(xs, ys, masks, None))
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    for n, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(net.params[n][k].numpy(),
                                       np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n}/{k}")
    # and the JSON reads back in the JAX package
    assert jgc.ComputationGraphConfiguration.from_json(
        conf.to_json()).to_json() == jnet.conf.to_json()
