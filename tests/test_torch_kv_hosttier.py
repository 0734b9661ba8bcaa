"""The host KV tier in the port (``serving/kv/hosttier.py``, the prefix
cache's spill and second chance, ``DecodeEngine(host_kv_bytes=...)``) held
against the JAX package's, on the CPU.

The model is the JAX tests' own (TinyTransformer with a 13-token
vocabulary, d_model 32, 4 heads, 2 blocks, kv_block_size 8, a pool of 9
blocks), built in the JAX package and carried across as numpy arrays.
Pinned here:

- ``HostKVTier`` answers one sequence of operations as the JAX tier does
  (the byte budget's LRU, idempotent puts, oversized entries refused,
  ``get`` touching without consuming, ``purge``);
- evicted prefix blocks spill and come back on a later chain hit with the
  tokens of the engine without a tier, and the spills, restores, drops and
  prefix hits of the JAX engine on the same prompts;
- restores write the pool tensors in place (every leaf keeps its
  ``data_ptr()``) and add no program; a restored block evicted again
  before its rows landed leaves the tier's copy standing;
- a weight swap purges the tier and empties the chain-head digest.
"""

from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.kv import HostKVTier as JaxTier

from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.decode import _Request
from deeplearning4j_tpu_torch.serving.kv import HostKVTier
from deeplearning4j_tpu_torch.serving.kv.prefix import chain_hashes
from test_torch_kv_migrate import jax_tiny
from test_torch_regularised_training import port_of

V, MAXLEN, BS = 13, 64, 8


@pytest.fixture(scope="module")
def tiny():
    jnet = jax_tiny()
    return jnet, port_of(jnet)


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, V, size=n))) for n in sizes]


def _kw(**kw):
    return dict(dict(slots=2, max_len=MAXLEN, kv="paged", kv_block_size=BS,
                     prefix_cache=True, chunk_tokens=8, kv_blocks=9), **kw)


def _tier_script(Tier, engine):
    """One op sequence over a tier of 300 bytes (100-byte entries); what
    every op gave."""
    log = []
    tier = Tier(byte_budget=300, engine=engine)

    def row(v, n=25):
        return {"k": np.full(n, v, np.float32)}
    for i, h in enumerate((b"h1", b"h2", b"h3")):
        log.append(("put", tier.put(h, b"p", (1, i), row(i))))
    log.append(("full", len(tier), tier.bytes_used, tier.stats()))
    log.append(("again", tier.put(b"h1", b"p", (1,), row(9)),
                tier.stats()))                  # a refresh, no new spill
    e = tier.get(b"h2")
    log.append(("get", e.parent, e.tokens, e.nbytes, e.rows["k"].tolist(),
                tier.has(b"h2")))
    log.append(("miss", tier.get(b"nope")))
    log.append(("evict", tier.put(b"h4", b"h2", (4,), row(4)),
                [tier.has(h) for h in (b"h1", b"h2", b"h3", b"h4")],
                tier.stats()))
    log.append(("huge", tier.put(b"big", b"p", (5,), row(5, 200)),
                tier.has(b"big"), tier.stats()))
    log.append(("purge", tier.purge(), len(tier), tier.bytes_used,
                tier.stats()))
    return log


def test_the_tier_answers_as_the_jax_tier():
    assert _tier_script(HostKVTier, "tier-port") == \
        _tier_script(JaxTier, "tier-jax")
    with pytest.raises(ValueError, match="byte_budget"):
        HostKVTier(0)


def _run(make, prompts, passes=2, new=4):
    """Every prompt ``passes`` times, one at a time; the tokens, the
    engine's stats and pool info."""
    eng = make().start()
    try:
        outs = [eng.generate(p, max_new_tokens=new)["tokens"]
                for _ in range(passes) for p in prompts]
        return outs, eng.stats(), eng.kv_pool_info()
    finally:
        eng.stop()


def test_spill_and_restore_match_the_tierless_engine_and_jax(tiny):
    jnet, net = tiny
    prompts = _prompts((40, 40, 40, 40), seed=3)
    base, bst, _ = _run(lambda: DecodeEngine(net, **_kw()), prompts)
    got, st, info = _run(
        lambda: DecodeEngine(net, **_kw(host_kv_bytes=32 << 20)), prompts)
    want, jst, jinfo = _run(
        lambda: JaxDecode(jnet, **_kw(host_kv_bytes=32 << 20)), prompts)
    assert got == base == want
    assert info["host_tier"]["spills"] > 0 and st["kv"]["host_restores"] > 0
    assert st["kv"]["prefix_hits"] > bst["kv"]["prefix_hits"]
    keys = ("host_restores", "prefix_hits", "prefix_tokens_saved",
            "cow_copies", "blocks_in_use", "blocks_cached", "chain_heads",
            "host_tier")
    assert {k: st["kv"][k] for k in keys} == {k: jst["kv"][k] for k in keys}
    assert info == jinfo
    assert info["blocks_in_use"] == 0
    assert st["compiled_programs"] == 1 and st["kv"]["kv_programs"] == 2


def test_restores_write_in_place_and_add_no_program(tiny):
    _, net = tiny
    prompts = _prompts((40, 40, 40, 40), seed=3)
    eng = DecodeEngine(net, **_kw(host_kv_bytes=32 << 20)).start()
    try:
        ptrs = [t.data_ptr() for _, t in eng._pool_leaf_items()]
        progs = eng.program_stats()
        for _ in range(2):
            for p in prompts:
                eng.generate(p, max_new_tokens=4)
        assert eng.stats()["kv"]["host_restores"] > 0
        assert [t.data_ptr() for _, t in eng._pool_leaf_items()] == ptrs
        assert eng.program_stats() == progs and eng.trace_count == 1
    finally:
        eng.stop()


def test_a_restore_evicted_before_it_landed_keeps_the_tier_copy(tiny):
    """The pending-restore race: a request restores blocks from the tier,
    then cannot claim the rest of its blocks and gives them back; the
    restored blocks (cached, their rows not yet on the pool) are evicted
    again at once. The eviction must not spill their stale rows: the
    pending restore is dropped and the tier's entry stands, so the next
    request restores the right rows."""
    _, net = tiny
    prompts = _prompts((40, 40, 40, 40), seed=3)
    want, _, _ = _run(lambda: DecodeEngine(net, **_kw()), prompts[:1],
                      passes=1)
    eng = DecodeEngine(net, **_kw(host_kv_bytes=32 << 20)).start()
    try:
        for p in prompts:                        # the first is spilled
            eng.generate(p, max_new_tokens=4)
    finally:
        eng.stop()
    tier, pool = eng._host_tier, eng._pool
    hashes = [bytes.fromhex(h) for h in chain_hashes(prompts[0], BS)]
    assert all(tier.has(h) for h in hashes)      # 4 blocks of 8
    entries = [tier._entries[h] for h in hashes]
    held = pool.alloc(3)                         # 5 left: 4 restores + 1
    req = _Request(prompts[0], 4, 0, 0.0, 0, Future())
    with eng._cv:
        eng._queue.append(req)
        eng._admit_locked()
    assert eng.kv_exhausted and eng._slot_reqs == [None, None]
    assert eng.stats()["kv"]["host_restores"] == 4
    assert len(eng._pending_restores) == 4
    pending = set(eng._pending_restores)
    taken = pool.alloc(pool.free_count)          # evicts all four again
    assert pending <= set(taken)
    assert eng._pending_restores == {}
    # the tier's entries stand as they were: nothing stale was spilled
    # over them (a spill would put a new entry)
    assert [tier._entries.get(h) for h in hashes] == entries
    for b in held + taken:
        pool.decref(b)
    with eng._cv:
        eng._queue.clear()
        eng._kv_blocked = False
    eng.start()
    try:
        got = eng.generate(prompts[0], max_new_tokens=4)["tokens"]
        assert eng.stats()["kv"]["host_restores"] == 8
    finally:
        eng.stop()
    assert got == want[0]
    assert eng.kv_pool_info()["blocks_in_use"] == 0


def test_stop_lands_pending_restores(tiny):
    _, net = tiny
    prompts = _prompts((40, 40, 40, 40), seed=3)
    eng = DecodeEngine(net, **_kw(host_kv_bytes=32 << 20)).start()
    try:
        for p in prompts:
            eng.generate(p, max_new_tokens=4)
    finally:
        eng.stop()
    req = _Request(prompts[0], 4, 0, 0.0, 0, Future())
    with eng._cv:
        eng._queue.append(req)
        eng._admit_locked()
    bids = sorted(eng._pending_restores)
    rows = {b: eng._pending_restores[b] for b in bids}
    assert len(bids) == 4 and eng._slot_reqs[0] is req
    eng.stop()                                   # lands them, frees req
    assert eng._pending_restores == {}
    got = eng._gather_rows(bids)
    for j, b in enumerate(bids):
        for k, row in rows[b].items():
            np.testing.assert_array_equal(got[k][j], row)
    assert eng.kv_pool_info()["blocks_in_use"] == 0


def test_a_swap_purges_the_tier_and_the_chain_heads(tiny):
    _, net = tiny
    eng = DecodeEngine(net, **_kw(host_kv_bytes=32 << 20)).start()
    try:
        for p in _prompts((40, 40, 40), seed=5):
            eng.generate(p, max_new_tokens=2)
        assert eng.stats()["kv"]["chain_heads"]
        assert len(eng._host_tier) > 0
        other = port_of(jax_tiny(seed=11))
        eng.swap_weights(other.params)
        kv = eng.stats()["kv"]
        assert kv["chain_heads"] == []
        assert kv["host_tier"]["blocks"] == 0 and kv["host_tier"]["bytes"] == 0
        out = eng.generate(_prompts((20,), seed=6)[0], max_new_tokens=2)
        assert len(out["tokens"]) == 2 and eng.stats()["kv"]["chain_heads"]
    finally:
        eng.stop()
