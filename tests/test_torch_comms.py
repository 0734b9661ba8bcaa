"""The port's gradient data plane (exec/comms.py) against the JAX
package's, in-process on the CPU.

- **Pure pieces** -- ``bucketize`` equal to JAX's on every size;
  ``encode_bucket`` byte for byte JAX's for dense and sparse payloads,
  each package decoding the other's; corrupt payloads rejected;
  ``ThresholdCodec`` bit for bit JAX's codec and the port's
  ``parallel.compression.EncodingHandler`` (message, residual carry,
  threshold walk).
- **Chain arithmetic** -- N ``ChainComms`` members on loopback threads give
  output BITWISE-equal to the star's rank-ordered ``total + v`` loop and
  single float32 division, across ragged buckets and repeated steps; a
  chain of a JAX member and a port member (the same wire bytes) too.
- **Elasticity** -- a peer death mid-allreduce surfaces ``CommsError`` (not
  a hang), the survivors ``configure()`` a new generation and complete;
  ``should_abort`` interrupts a stuck wait; residuals reset on a
  generation change; the metrics are JAX's names.
"""

import threading

import numpy as np
import pytest

import deeplearning4j_tpu.exec.comms as jax_comms
from deeplearning4j_tpu_torch.exec.comms import (ChainComms,
                                                 CommsAbortedError,
                                                 CommsError, ThresholdCodec,
                                                 bucketize, decode_bucket,
                                                 encode_bucket)


# ---------------------------------------------------------------------------
# bucketize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mb", [(1, 4.0), (5, 4.0), (1001, 0.0001),
                                  (1 + 3 * 262, 0.001),
                                  (1 + 2 * 262144 + 100, 1.0),
                                  (3156948, 4.0), (257, 0.005)])
def test_bucketize_equals_jax(n, mb):
    got = bucketize(n, bucket_mb=mb)
    assert got == jax_comms.bucketize(n, bucket_mb=mb)
    assert got[0] == (0, 1) and got[-1][1] == n
    assert all(a2 == b1 for (_, b1), (a2, _) in zip(got, got[1:]))
    with pytest.raises(ValueError):
        bucketize(0, bucket_mb=mb)


def test_bucketize_head_plus_fixed_body_with_ragged_tail():
    per = 256 * 1024       # 1 MB of f32
    n = 1 + per + per + 100
    assert bucketize(n, bucket_mb=1.0) == [
        (0, 1), (1, 1 + per), (1 + per, 1 + 2 * per), (1 + 2 * per, n)]
    assert bucketize(5, bucket_mb=4.0) == [(0, 1), (1, 5)]
    assert bucketize(1, bucket_mb=4.0) == [(0, 1)]


# ---------------------------------------------------------------------------
# the wire encoding
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(5)
    dense = rng.normal(size=300).astype(np.float32)
    sparse = np.zeros(1000, np.float32)
    sparse[rng.choice(1000, 40, replace=False)] = rng.normal(size=40)
    edge = np.zeros(8, np.float32)
    edge[:4] = 1.0          # 8 * 4 == 8 * 4: dense (sparse must win)
    return {"dense": dense, "sparse": sparse, "edge": edge,
            "zeros": np.zeros(16, np.float32),
            "one": np.array([-2.5], np.float32)}


@pytest.mark.parametrize("kind", sorted(_payloads()))
def test_encode_bucket_is_the_jax_bytes(kind):
    vals = _payloads()[kind]
    wire, payload = encode_bucket(vals)
    jwire, jpayload = jax_comms.encode_bucket(vals)
    assert wire == jwire and bytes(payload) == bytes(jpayload)
    np.testing.assert_array_equal(decode_bucket(wire, payload, vals.size),
                                  vals)
    np.testing.assert_array_equal(
        jax_comms.decode_bucket(wire, payload, vals.size), vals)
    if kind == "sparse":
        assert wire == 1 and len(payload) == 40 * 8
    if kind in ("dense", "edge"):
        assert wire == 0 and len(payload) == vals.size * 4


def test_decode_bucket_rejects_corrupt_payloads():
    with pytest.raises(CommsError):
        decode_bucket(0, b"\0" * 8, 3)         # dense size mismatch
    with pytest.raises(CommsError):
        decode_bucket(1, b"\0" * 12, 4)        # sparse not 8-aligned
    bad_idx = (np.array([9], np.int32).tobytes()
               + np.array([1.0], np.float32).tobytes())
    with pytest.raises(CommsError):
        decode_bucket(1, bad_idx, 4)           # index out of range
    neg = (np.array([-1], np.int32).tobytes()
           + np.array([1.0], np.float32).tobytes())
    with pytest.raises(CommsError):
        decode_bucket(1, neg, 4)


# ---------------------------------------------------------------------------
# the threshold codec
# ---------------------------------------------------------------------------

def test_threshold_codec_matches_jax_and_the_encoding_handler():
    """Decoded message, residual carry and the adaptive-threshold
    trajectory bit for bit JAX's codec and the port's EncodingHandler
    (plain tensor code on the CPU) over many steps."""
    import torch

    from deeplearning4j_tpu_torch.parallel.compression import (
        EncodingHandler, threshold_decode)
    n, steps = 400, 12
    rng = np.random.default_rng(0)
    kw = dict(threshold=1e-2, min_threshold=1e-4, threshold_step=1e-3,
              capacity_fraction=0.1)
    ref = EncodingHandler(**kw)
    theirs = jax_comms.ThresholdCodec(n, **kw)
    ours = ThresholdCodec(n, **kw)
    for _ in range(steps):
        g = rng.normal(scale=0.05, size=n).astype(np.float32)
        idx, vals, _ = ref.encode(torch.from_numpy(g))
        ref_msg = threshold_decode(idx, vals, n).numpy()
        msg = ours.encode(g)
        np.testing.assert_array_equal(msg, theirs.encode(g))
        np.testing.assert_array_equal(msg, ref_msg)
        np.testing.assert_array_equal(ours.residual, theirs.residual)
        np.testing.assert_array_equal(ours.residual, ref.residual.numpy())
        assert ours.threshold == theirs.threshold == ref.threshold
        assert ours.last_count == theirs.last_count


def test_threshold_codec_reset_clears_residual_and_threshold_walk():
    from deeplearning4j_tpu_torch.monitor import get_registry
    c = ThresholdCodec(50, threshold=1e-2, capacity_fraction=0.2)
    c.encode(np.full(50, 0.5, np.float32))
    assert np.abs(c.residual).sum() > 0
    assert c.threshold != pytest.approx(1e-2, abs=0)   # walked by adapt
    before = get_registry().render()
    c.reset()
    assert not c.residual.any()
    assert c.threshold == 1e-2
    assert c.resets == 1
    after = get_registry().render()
    assert "dl4jtpu_cluster_residual_resets_total" in after
    assert after != before


# ---------------------------------------------------------------------------
# the chain itself (loopback, in-process threads)
# ---------------------------------------------------------------------------

def _form_chain(members, generation=1):
    n = len(members)
    eps = {r: ("127.0.0.1", m.data_port) for r, m in enumerate(members)}
    errs = []

    def cfg(r):
        try:
            members[r].configure(generation, r, n, eps)
        except BaseException as e:     # noqa: BLE001 -- surfaced below
            errs.append((r, e))

    ts = [threading.Thread(target=cfg, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs, errs
    return members


def _chain_step(members, step, vecs, rows):
    out = [None] * len(members)
    errs = []

    def go(r):
        try:
            out[r] = members[r].allreduce(step, vecs[r], rows[r])
        except BaseException as e:     # noqa: BLE001
            errs.append((r, e))

    ts = [threading.Thread(target=go, args=(r,)) for r in range(len(members))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return out, errs


def _star_reference(vecs, rows):
    """The star coordinator's arithmetic: rank-ordered ``total + v`` then
    one float32 division -- the bitwise oracle."""
    total = None
    for v in vecs:
        total = v.copy() if total is None else total + v
    return total / np.float32(sum(rows))


@pytest.mark.parametrize("world", [2, 3])
def test_dense_chain_bitwise_equals_star_across_steps(world):
    n = 1001                     # head + 40 ragged micro-buckets
    members = _form_chain([ChainComms(bucket_mb=0.0001)
                           for _ in range(world)])
    try:
        rng = np.random.default_rng(7)
        rows = [11] * (world - 1) + [10]
        for step in range(3):    # several steps over the SAME sockets
            vecs = [rng.normal(size=n).astype(np.float32)
                    for _ in range(world)]
            out, errs = _chain_step(members, step, vecs, rows)
            assert not errs, errs
            want = _star_reference(vecs, rows)
            coord = jax_star(vecs, rows)
            np.testing.assert_array_equal(want, coord)
            for r in range(world):
                assert out[r].tobytes() == want.tobytes()
            assert members[0].last["buckets"] > 30
    finally:
        for m in members:
            m.close()


def jax_star(vecs, rows):
    """The same vectors through the JAX package's coordinator's star."""
    coord = jax_elastic().ElasticCoordinator(len(vecs))
    for r in range(len(vecs)):
        coord.join(f"w{r}")
    for r in range(len(vecs)):
        coord.sync(f"w{r}", 1)
    ranks = {w: m["rank"] for w, m in coord.state()["members"].items()}
    for w, r in ranks.items():
        coord.contribute(w, 1, 0, rows[r], vecs[r])
    return coord.wait_reduced("w0", 1, 0, timeout=5.0)


def jax_elastic():
    import deeplearning4j_tpu.exec.elastic as m
    return m


@pytest.mark.parametrize("jax_rank", [0, 1])
def test_a_jax_member_and_a_port_member_form_one_chain(jax_rank):
    """The frames are the JAX package's bytes: a chain of one member from
    each package reduces, both directions, to the star's result."""
    kw = dict(bucket_mb=0.001)
    members = [ChainComms(**kw), ChainComms(**kw)]
    members[jax_rank].close()
    members[jax_rank] = jax_comms.ChainComms(**kw)
    _form_chain(members)
    try:
        rng = np.random.default_rng(11)
        for step in range(2):
            vecs = [rng.normal(size=777).astype(np.float32)
                    for _ in range(2)]
            out, errs = _chain_step(members, step, vecs, [3, 5])
            assert not errs, errs
            want = _star_reference(vecs, [3, 5])
            for o in out:
                assert o.tobytes() == want.tobytes()
    finally:
        for m in members:
            m.close()


def test_tiny_model_and_world_one_short_circuit():
    members = _form_chain([ChainComms(bucket_mb=4.0) for _ in range(2)])
    try:
        vecs = [np.array([2.0, 4.0, 6.0], np.float32),
                np.array([1.0, 3.0, 5.0], np.float32)]
        out, errs = _chain_step(members, 0, vecs, [1, 1])
        assert not errs, errs
        np.testing.assert_array_equal(out[0], _star_reference(vecs, [1, 1]))
        assert members[0].last["buckets"] == 2
    finally:
        for m in members:
            m.close()
    solo = ChainComms()
    try:
        solo.configure(1, 0, 1, {})
        got = solo.allreduce(0, np.array([3.0, 9.0], np.float32), 2)
        np.testing.assert_array_equal(got, np.array([1.5, 4.5], np.float32))
    finally:
        solo.close()


def test_threshold_chain_transports_exact_compressed_sums():
    """codec="threshold": each member compresses its OWN contribution
    once; the chain moves those messages EXACTLY (head element exact)."""
    n = 257
    opts = {"threshold": 1e-2, "capacity_fraction": 0.1}
    members = _form_chain([ChainComms(codec="threshold", bucket_mb=0.0001,
                                      codec_opts=opts) for _ in range(2)])
    try:
        rng = np.random.default_rng(3)
        vecs = [rng.normal(scale=0.05, size=n).astype(np.float32)
                for _ in range(2)]
        refs = [jax_comms.ThresholdCodec(n - 1, **opts) for _ in range(2)]
        want_msgs = [np.concatenate([v[:1], c.encode(v[1:])])
                     for v, c in zip(vecs, refs)]
        out, errs = _chain_step(members, 0, vecs, [4, 4])
        assert not errs, errs
        want = _star_reference(want_msgs, [4, 4])
        np.testing.assert_array_equal(out[0], want)
        np.testing.assert_array_equal(out[1], want)
        assert members[0].last["compression_ratio"] > 1.5
        assert np.abs(members[0].codec_state.residual).sum() > 0
    finally:
        for m in members:
            m.close()


def test_peer_death_mid_allreduce_raises_comms_error_then_chain_reforms():
    n = 40_000
    members = _form_chain([ChainComms(bucket_mb=0.01) for _ in range(3)])
    try:
        vecs = [np.full(n, float(r + 1), np.float32) for r in range(3)]
        killed = threading.Event()

        def assassin():
            killed.wait(timeout=10)
            members[1].close()          # tears both of rank 1's sockets

        t = threading.Thread(target=assassin)
        t.start()
        errs = []

        def survivor(r):
            try:
                if r == 0:
                    killed.set()
                members[r].allreduce(0, vecs[r], 1)
            except CommsError as e:
                errs.append((r, e))

        ts = [threading.Thread(target=survivor, args=(r,)) for r in (0, 2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=30)
        t.join(timeout=15)
        assert errs, "no survivor noticed the dead peer"
        assert all(not th.is_alive() for th in ts)
        surv = _form_chain([members[0], members[2]], generation=2)
        out2, errs2 = _chain_step(surv, 0, [vecs[0], vecs[2]], [1, 1])
        assert not errs2, errs2
        want = _star_reference([vecs[0], vecs[2]], [1, 1])
        np.testing.assert_array_equal(out2[0], want)
        np.testing.assert_array_equal(out2[1], want)
    finally:
        for m in members:
            m.close()


def test_should_abort_interrupts_a_stuck_peer_wait():
    members = _form_chain([ChainComms(bucket_mb=4.0) for _ in range(2)])
    try:
        flag = threading.Event()
        flag.set()
        with pytest.raises(CommsAbortedError):
            members[0].allreduce(0, np.ones(8, np.float32), 1,
                                 should_abort=flag.is_set)
    finally:
        for m in members:
            m.close()


def test_configure_resets_residual_on_generation_change():
    c = ChainComms(codec="threshold",
                   codec_opts={"threshold": 1e-2, "capacity_fraction": 0.2})
    try:
        c.configure(1, 0, 1, {})
        c.allreduce(0, np.full(64, 0.5, np.float32), 1)
        assert np.abs(c.codec_state.residual).sum() > 0
        resets0 = c.codec_state.resets
        c.configure(1, 0, 1, {})                   # same generation: kept
        assert np.abs(c.codec_state.residual).sum() > 0
        assert c.codec_state.resets == resets0
        c.configure(2, 0, 1, {})                   # reform: dropped
        assert not c.codec_state.residual.any()
        assert c.codec_state.resets == resets0 + 1
    finally:
        c.close()


def test_allreduce_emits_comm_metrics():
    from deeplearning4j_tpu_torch.exec.comms import record_star_bytes
    from deeplearning4j_tpu_torch.monitor import get_registry
    members = _form_chain([ChainComms(bucket_mb=0.001) for _ in range(2)])
    try:
        vecs = [np.ones(600, np.float32), np.ones(600, np.float32)]
        out, errs = _chain_step(members, 0, vecs, [1, 1])
        assert not errs, errs
        record_star_bytes(8, 8)
        text = get_registry().render()
        assert 'dl4jtpu_cluster_comm_bytes_total{' in text
        assert 'direction="sent"' in text and 'direction="recv"' in text
        assert "dl4jtpu_cluster_compression_ratio" in text
        assert "dl4jtpu_cluster_bucket_seconds" in text
        for m in members:
            assert m.bytes_sent > 0 and m.bytes_recv > 0
            assert m.last["wall_s"] > 0
            # header + payload per frame: both directions of 2 buckets
            assert m.bytes_sent == m.bytes_recv
    finally:
        for m in members:
            m.close()
