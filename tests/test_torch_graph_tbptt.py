"""Truncated BPTT and ``rnn_time_step`` over a ComputationGraph in the
port, held against the JAX package's graph on the CPU.

The graph is TextGenerationLSTM's chain at small width, ``in`` -> LSTM(16)
-> LSTM(16) -> RnnOutputLayer(9) (Adam(1e-3), element-wise clipping at
10), the JAX graph's initial parameters carried over; ``backprop_type
("tbptt", 4, 4)`` over T=12 (three chunks) and T=10 (the last chunk 2
steps), with and without a feature mask and a label mask (the feature
mask reaches only the input-fed LSTM, caveat R6, in both packages). On
the CPU the JAX package runs its LSTM through its scan, the port through
its kernels' plain versions. Tolerances are tests/test_torch_training.py's:
scores 1e-6 relative, parameters 2e-6 absolute after three batches.
``rnn_time_step`` over three calls (two of 3 steps, then one 2-D step)
matches the JAX graph's to 1e-6, equals the full forward's steps, and
after ``rnn_clear_previous_state`` repeats the first call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.data import MultiDataSet

from test_torch_fit_stream import _graph_conf, _graph_params_close
from test_torch_masks import masks
from test_torch_regularised_training import port_of
from test_torch_training import B, _batch

OUT_TOL, LOSS_RTOL = 1e-6, 1e-6


def _pair(tbptt=4):
    jnet = JaxCG(_graph_conf(tbptt)).init()
    return jnet, port_of(jnet)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("t", [12, 10])
def test_tbptt_batches_match_jax(t, masked):
    jnet, net = _pair()
    assert net.conf.backprop_type == "tbptt"
    for step in range(3):
        x, y = _batch(30 + step, t=t)
        mf, ml = masks(30 + step, n=B, t=t) if masked else (None, None)
        jnet.fit(JaxMDS([x], [y], [mf], [ml]))
        net.fit(MultiDataSet([x], [y], [mf], [ml]))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    _graph_params_close(jnet, net)
    assert net.iteration == jnet.iteration == 3


def test_tbptt_chunks_one_step_each_from_the_carried_state():
    """Every chunk is one step (three a batch at T=12, the carry map
    carried across them); a chunk started from zero state instead would
    train other parameters."""
    _, net = _pair()
    steps = []
    run = net._run
    net._run = lambda graphs, fn, *a: steps.append(a[4]) or run(graphs, fn,
                                                                 *a)
    x, y = _batch(3, t=12)
    net.fit(x, y)
    assert [None if c is None else sorted(c) for c in steps] == \
        [[], ["l0", "l1"], ["l0", "l1"]]
    assert all(not t.requires_grad for c in steps[1:] for hc in c.values()
               for t in hc)
    _, cut = _pair()
    cut.conf.tbptt_fwd_length = 12
    for chunk in range(3):
        cut.fit(x[:, 4 * chunk:4 * chunk + 4], y[:, 4 * chunk:4 * chunk + 4])
    assert not torch.equal(cut.params["l0"]["RW"], net.params["l0"]["RW"])


def test_fit_scan_still_refuses_tbptt():
    _, net = _pair()
    x, y = _batch(0)
    with pytest.raises(ValueError, match="tbptt"):
        net.fit_scan(x[None], y[None])


def test_rnn_time_step_matches_jax_over_three_calls():
    jnet, net = _pair(None)
    x, _ = _batch(7, t=7)
    calls = [x[:, :3], x[:, 3:6], x[:, 6]]
    for step in calls:
        got = net.rnn_time_step(step).numpy()
        want = np.asarray(jnet.rnn_time_step(jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
    assert got.shape == (B, 1, 9)
    full = net.output(x, bucketed=False).numpy()
    np.testing.assert_allclose(got[:, 0], full[:, -1], rtol=0, atol=OUT_TOL)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    again = net.rnn_time_step(calls[0]).numpy()
    np.testing.assert_allclose(again, full[:, :3], rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(
        again, np.asarray(jnet.rnn_time_step(jnp.asarray(calls[0]))),
        rtol=0, atol=OUT_TOL)
    assert sorted(net._rnn_carries) == ["l0", "l1"]


def test_rnn_time_step_runs_the_inference_path_without_draws():
    """Inference precision and no draws: a graph with dropout steps the
    same as without it; on the CPU nothing launches."""
    jnet, net = _pair(None)
    x, _ = _batch(8, t=4)
    plain = net.rnn_time_step(x).numpy()
    net.rnn_clear_previous_state()
    for node in net.conf.nodes.values():
        if node.layer is not None:
            node.layer.dropout = 0.5
    ops.reset_launch_counts()
    np.testing.assert_array_equal(net.rnn_time_step(x).numpy(), plain)
    assert ops.launch_counts() == {}
