"""The port's paged-KV features -- the block pool's refcounts and
eviction, the prefix cache with copy-on-write, chunked prefill -- held
against the JAX package's, on the CPU.

The models are the JAX tests' own at small size (TinyTransformer with 2
blocks of d_model 32 and 4 heads, max_len 64, a 13-token vocabulary; a
2 x LSTM(16) char model), built in the JAX package and carried across as
numpy arrays. Tolerances (float32): 1e-5 on activations and caches of
single layers; tokens exactly (the port's engines against its plain
engine, greedy and sampled; greedy against the JAX engine).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.random import PRNGKey as jax_key

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.layers.attention import \
    MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.kv import BlockPool as JaxPool
from deeplearning4j_tpu.serving.kv import \
    PoolExhaustedError as JaxExhausted
from deeplearning4j_tpu.serving.kv import PrefixCache as JaxPrefix
from deeplearning4j_tpu.serving.kv import blocks_for_span as jax_bfs
from deeplearning4j_tpu.serving.kv import chain_hashes as jax_chain_hashes
from deeplearning4j_tpu.serving.kv import plan_chunks as jax_plan_chunks
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import layer_from_dict
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.decode import _Request, generate_naive
from deeplearning4j_tpu_torch.serving.kv import (SCRATCH_BLOCK, BlockPool,
                                                 HostKVTier,
                                                 PoolExhaustedError,
                                                 PrefixCache,
                                                 blocks_for_span,
                                                 chain_hashes, plan_chunks)
from test_torch_regularised_training import port_of

V, MAXLEN = 13, 64
ACT_TOL = 1e-5


def jax_transformer(seed=7, n_layers=2, d_model=32, n_heads=4):
    return JaxTiny(vocab_size=V, n_layers=n_layers, d_model=d_model,
                   n_heads=n_heads, max_len=MAXLEN, seed=seed).init()


def jax_lstm(seed=7, width=16, layers=2):
    b = (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-2))
         .weight_init("xavier").list())
    for _ in range(layers):
        b = b.layer(JaxLSTM(n_out=width, activation="tanh"))
    conf = (b.layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V)).build())
    return JaxMLN(conf).init()


@pytest.fixture(scope="module")
def tiny():
    jnet = jax_transformer()
    return jnet, port_of(jnet)


def prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, V, size=n))) for n in sizes]


def shared_prompts():
    """Prompts over one 36-token stem (two full 16-blocks and a partial
    one) with tails diverging at several offsets, and one unrelated."""
    rng = np.random.default_rng(11)
    stem = list(map(int, rng.integers(0, V, size=36)))
    tails = prompts((5, 9, 3), seed=4)
    return [stem + tails[0], stem[:20] + tails[1], stem + tails[0][:2],
            stem[:33] + tails[2], prompts((7,), seed=9)[0], list(stem)]


def run_engine(eng, reqs, n=10, concurrent=False):
    """Tokens of ``reqs`` ((prompt, temperature, seed, top_k) tuples) and
    the engine's stats after the last."""
    eng.start()
    try:
        if concurrent:
            futs = [eng.submit(p, max_new_tokens=n, seed=s, temperature=t,
                               top_k=k) for p, t, s, k in reqs]
            out = [f.result(timeout=120)["tokens"] for f in futs]
        else:
            out = [eng.generate(p, max_new_tokens=n, seed=s, temperature=t,
                                top_k=k, timeout=120)["tokens"]
                   for p, t, s, k in reqs]
        return out, eng.stats()
    finally:
        eng.stop()


# ------------------------------------------------------- pool and prefix

def _pool_script(Pool, Prefix, Exhausted):
    """One op sequence over a pool of 8 blocks of 4 and its prefix cache;
    returns what every op gave."""
    log, dropped = [], []
    p = Pool(8, 4)
    pc = Prefix(p)
    hook = p.on_evict
    p.on_evict = lambda b: (dropped.append(b), hook(b))

    def state(tag):
        log.append((tag, p.in_use, p.free_count, p.cached_count,
                    p.high_water, len(pc),
                    [p.refcount(b) for b in range(8)],
                    [p.is_cached(b) for b in range(8)]))
    prompt = list(range(10))
    a = p.alloc(3)
    log.append(("alloc", a, pc.insert(prompt, a)))
    for b in a:
        p.decref(b)
    state("published")
    shared, cow, skip = pc.match(prompt)
    log.append(("match", shared, cow, skip))
    state("claimed")
    for b in shared:
        p.decref(b)
    other = prompt[:6] + [99, 98, 97, 96]
    shared, cow, skip = pc.match(other)
    log.append(("match-cow", shared, cow, skip))
    state("cow")
    for b in shared + [cow[0]]:
        p.decref(b)
    c = p.alloc(6)                  # evicts the least recent cached blocks
    log.append(("alloc-evict", c, list(dropped)))
    state("evicted")
    log.append(("match-after", pc.match(prompt)))
    try:
        p.alloc(3)
    except Exhausted as e:
        log.append(("exhausted", e.need, e.free, e.in_use, e.cached))
    second = list(range(20, 28)) + [1]
    log.append(("insert2", pc.insert(second, c[:2]), pc.insert(second, c)))
    for b in c:
        p.decref(b)
    state("released")
    log.append(("heads", pc.chain_heads()))
    log.append(("flush", pc.clear(), list(dropped)))
    state("flushed")
    return log


def test_pool_and_prefix_cache_follow_jax_through_one_op_sequence():
    assert _pool_script(BlockPool, PrefixCache, PoolExhaustedError) == \
        _pool_script(JaxPool, JaxPrefix, JaxExhausted)


def test_pool_refcounts_lru_and_errors():
    p = BlockPool(4, 8)
    dropped = []
    p.on_evict = dropped.append
    a = p.alloc(3)
    for b in a:
        p.mark_cached(b)
        p.decref(b)
    assert p.free_count == 3 and p.cached_count == 3 and p.in_use == 0
    p.incref(a[1])                  # a hit revives the middle block
    assert sorted(p.alloc(2)) == sorted([a[0], a[2]])
    assert dropped == [a[0], a[2]]
    with pytest.raises(PoolExhaustedError) as e:
        p.alloc(1)
    assert (e.value.need, e.value.free, e.value.in_use) == (1, 0, 3)
    p.decref(a[1])
    assert p.flush_cached() == 1
    with pytest.raises(ValueError):
        p.incref(SCRATCH_BLOCK)


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_chain_hashes_equal_the_jax_bytes(bs):
    for toks in prompts((1, 4, 5, 17, 33, 64), seed=bs):
        for limit in (None, 1, 3):
            assert chain_hashes(toks, bs, limit) == \
                jax_chain_hashes(toks, bs, limit)


def test_prefix_cache_tier_is_not_ported():
    """The tier is ported now (the name is the test's history): a cache
    over a tier spills each evicted published block with its chain hash,
    parent hash and tokens, and a later match restores it through the
    engine's hook, claimed at refcount 1 and cached, as the JAX cache
    does."""
    tier = HostKVTier(1 << 20, engine="prefix-test")
    pool = BlockPool(4, 4)
    pc = PrefixCache(pool, tier=tier)
    spilled, restored = [], []

    def spill(h, parent, toks, bid):
        spilled.append((h, parent, toks, bid))
        tier.put(h, parent, toks, {"k": np.full(4, bid, np.float32)})

    def restore(h, toks):
        restored.append((h, toks))
        return pool.alloc(1)[0]
    pc.spill_fn, pc.restore_fn = spill, restore
    prompt = list(range(9))
    a = pool.alloc(2)
    assert pc.insert(prompt, a) == 2
    for b in a:
        pool.decref(b)
    c = pool.alloc(3)                  # evicts both published blocks
    hashes = [bytes.fromhex(h) for h in chain_hashes(prompt, 4)]
    assert [(s[0], s[2], s[3]) for s in spilled] == [
        (hashes[0], (0, 1, 2, 3), a[0]), (hashes[1], (4, 5, 6, 7), a[1])]
    assert spilled[1][1] == hashes[0] and len(pc) == 0
    assert tier.stats()["spills"] == 2 and len(tier) == 2
    for b in c:
        pool.decref(b)
    shared, cow, skip = pc.match(prompt)
    assert restored == [(hashes[0], (0, 1, 2, 3)), (hashes[1], (4, 5, 6, 7))]
    assert (len(shared), cow, skip) == (2, None, 8)
    assert all(pool.refcount(b) == 1 and pool.is_cached(b) for b in shared)
    assert pc.chain_heads() == [h.hex() for h in hashes]
    for b in shared:
        pool.decref(b)
    assert pc.clear() == 2             # a swap's flush: the tier purged,
    assert len(tier) == 0 and len(spilled) == 2     # nothing spilled


def test_plan_chunks_and_blocks_for_span_match_jax_over_a_grid():
    for start in range(0, 12):
        for end in range(0, 20):
            for k in range(1, 7):
                assert plan_chunks(start, end, k) == \
                    jax_plan_chunks(start, end, k)
    for span in range(0, 70):
        for bs in (1, 3, 16):
            assert blocks_for_span(span, bs) == jax_bfs(span, bs)
    for fn in (plan_chunks, jax_plan_chunks):
        with pytest.raises(ValueError, match="chunk_tokens"):
            fn(0, 4, 0)


# ------------------------------------------------------------ the layers

def mha_pair(d=32, heads=4, seed=5):
    jl = JaxMHA(n_in=d, n_out=d, n_heads=heads, causal=True)
    layer = MultiHeadAttention(n_in=d, n_out=d, n_heads=heads, causal=True)
    r = np.random.RandomState(seed)
    shapes = {k: np.shape(a) for k, a in jl.init(jax_key(0)).items()}
    npp = {k: (r.randn(*s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in shapes.items()}
    return (jl, {k: jnp.asarray(a) for k, a in npp.items()}, layer,
            {k: torch.tensor(a) for k, a in npp.items()})


def page_tables(B, MB, seed=3):
    NB = B * MB + 1
    r = np.random.RandomState(seed)
    return (r.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB) \
        .astype(np.int32), NB


def _close(port, ref, tol=ACT_TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_attention_prefill_chunk_matches_jax(kv):
    """Two chunks of 5 rows per stream (starts 0/7/20, valid rows 5/3/0,
    then the next chunk) against the JAX layer: valid rows' outputs and
    the caches (the paged pool outside the scratch block) within 1e-5."""
    jl, jp, layer, pp = mha_pair()
    B, K, C, bs = 3, 5, 32, 8
    r = np.random.RandomState(1)
    if kv == "paged":
        tables, NB = page_tables(B, C // bs)
        jd = jl.init_paged_decode_state(jp, B, C, NB, bs)
        pd = layer.init_paged_decode_state(pp, B, C, NB, bs)
        jkw = {"block_tables": jnp.asarray(tables)}
        pkw = {"block_tables": torch.tensor(tables)}
    else:
        jd, pd = jl.init_decode_state(jp, B, C), \
            layer.init_decode_state(pp, B, C)
        jkw = pkw = {}
    start = np.array([0, 7, 20], np.int32)
    n = np.array([5, 3, 0], np.int32)
    for _ in range(2):
        x = r.randn(B, K, 32).astype(np.float32)
        jy, jd = jl.prefill_chunk(jp, jd, jnp.asarray(x), jnp.asarray(start),
                                  jnp.asarray(n), **jkw)
        py, pd = layer.prefill_chunk(pp, pd, torch.tensor(x),
                                     torch.tensor(start), torch.tensor(n),
                                     **pkw)
        for b in range(B):
            _close(py[b, :n[b]].numpy(), np.asarray(jy)[b, :n[b]])
        for key in pd:
            got, want = pd[key].numpy(), np.asarray(jd[key])
            if kv == "paged":
                got, want = got[1:], want[1:]
            _close(got, want)
        start = start + n
        n = np.array([4, 5, 2], np.int32)


def recurrent_pair(kind, seed=2):
    """A JAX recurrent layer (6 -> 8, tanh), the port's from its JSON, the
    JAX parameters and their torch copies, and a random carry for B=3."""
    jl = getattr(__import__("deeplearning4j_tpu.nn.layers",
                            fromlist=[kind]), kind)(
        n_in=6, n_out=8, activation="tanh")
    layer = layer_from_dict(jl.to_dict())
    jparams = jl.init(jax_key(seed))
    pp = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    r = np.random.RandomState(seed + 1)
    carry = tuple(r.randn(3, 8).astype(np.float32)
                  for _ in range(1 if kind == "SimpleRnn" else 2))
    if kind == "SimpleRnn":
        return jl, layer, jparams, pp, jnp.asarray(carry[0]), \
            torch.tensor(carry[0])
    return (jl, layer, jparams, pp, tuple(jnp.asarray(c) for c in carry),
            tuple(torch.tensor(c) for c in carry))


def _leaves(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM", "SimpleRnn"])
def test_recurrent_prefill_chunk_carry_stack_matches_jax(kind):
    """The base protocol's scan of a recurrent layer's decode step, rows
    frozen past their count: outputs of valid rows, the final carry and
    every snapshot of the stack within 1e-5 of the JAX layer's."""
    jl, layer, jparams, pp, jd0, pd0 = recurrent_pair(kind)
    r = np.random.RandomState(3)
    B, K = 3, 4
    x = r.randn(B, K, 6).astype(np.float32)
    start = np.array([0, 3, 9], np.int32)
    n = np.array([4, 1, 0], np.int32)
    jy, jd, jst = jl.prefill_chunk(jparams, jd0, jnp.asarray(x),
                                   jnp.asarray(start), jnp.asarray(n),
                                   carry_stack=True)
    py, pd, pst = layer.prefill_chunk(pp, pd0, torch.tensor(x),
                                      torch.tensor(start), torch.tensor(n),
                                      carry_stack=True)
    for b in range(B):
        _close(py[b, :n[b]].numpy(), np.asarray(jy)[b, :n[b]])
    for got, want in zip(_leaves(pd) + _leaves(pst),
                         _leaves(jd) + _leaves(jst)):
        _close(got.numpy(), np.asarray(want))
    assert tuple(_leaves(pst)[0].shape) == (K, B, 8)


# ----------------------------------------------------------- the engines

MODES = {"paged": dict(kv="paged", prefix_cache=False),
         "prefix": dict(kv="paged"),
         "chunked": dict(kv="paged", prefix_cache=False, chunk_tokens=4),
         "prefix-chunked": dict(kv="paged", chunk_tokens=8)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_and_chunked_engines_match_the_plain_engine(tiny, mode):
    """Shared-prefix prompts, greedy and seeded sampling (with top-k), one
    at a time and then all at once: the same tokens as the port's plain
    dense engine."""
    _, net = tiny
    reqs = [(p, t, s, k) for p in shared_prompts()
            for t, s, k in ((0.0, 0, 0), (0.8, 9, 4))]
    want, _ = run_engine(DecodeEngine(net, slots=4, max_len=MAXLEN), reqs)
    got, st = run_engine(DecodeEngine(net, slots=4, max_len=MAXLEN,
                                      kv_block_size=16, **MODES[mode]), reqs)
    assert got == want
    again, _ = run_engine(DecodeEngine(net, slots=4, max_len=MAXLEN,
                                       kv_block_size=16, **MODES[mode]),
                          reqs, concurrent=True)
    assert again == want
    kv = st["kv"]
    assert kv["blocks_in_use"] == 0
    assert kv["prefix_cache"] == ("prefix" in mode)
    assert (kv["prefix_hits"] > 0) == ("prefix" in mode)
    assert (kv["prefill_chunks"] > 0) == ("chunked" in mode)


def test_greedy_tokens_and_counters_equal_the_jax_engine(tiny):
    """The same shared-prefix prompts one at a time through a paged engine
    with the prefix cache and chunks of 8 in both packages: the same
    greedy tokens, and the same prefix hits, tokens saved, copy-on-write
    copies, prefill chunks and tokens, cached blocks."""
    jnet, net = tiny
    reqs = [(p, 0.0, 0, 0) for p in shared_prompts()]
    kw = dict(slots=4, max_len=MAXLEN, kv="paged", kv_block_size=16,
              prefix_cache=True, chunk_tokens=8)
    want, jst = run_engine(JaxDecode(jnet, **kw), reqs)
    got, st = run_engine(DecodeEngine(net, **kw), reqs)
    assert got == want
    keys = ("prefix_cache", "chunk_tokens", "prefix_hits",
            "prefix_tokens_saved", "cow_copies", "prefill_chunks",
            "prefill_tokens", "blocks_in_use", "blocks_cached", "blocks",
            "blocks_free", "high_water", "chain_heads")
    assert {k: st["kv"][k] for k in keys} == {k: jst["kv"][k] for k in keys}
    assert st["kv"]["cow_copies"] > 0 and st["kv"]["prefix_hits"] > 0
    assert [generate_naive(net, p, 10, MAXLEN)["tokens"]
            for p, *_ in reqs] == want


def test_shared_prefix_reuse_and_cow_divergence():
    """JAX test_kv.py's case: two prompts over a common 64-token prefix,
    the second diverging inside a block (a copy-on-write). The outputs
    equal independent decodes; B claimed A's four prefix blocks and one
    copy."""
    jnet = JaxTiny(vocab_size=V, n_layers=2, d_model=32, n_heads=4,
                   max_len=96, seed=7).init()
    net = port_of(jnet)
    rng = np.random.default_rng(11)
    common = list(map(int, rng.integers(0, V, size=64)))
    cont_a = list(map(int, rng.integers(0, V, size=16)))
    cont_b = cont_a[:4] + list(map(int, rng.integers(0, V, size=12)))
    pa, pb = common + cont_a, common + cont_b
    assert pa != pb and pa[:68] == pb[:68]

    def run(prefix_cache):
        return run_engine(DecodeEngine(net, slots=2, max_len=96, kv="paged",
                                       kv_block_size=16,
                                       prefix_cache=prefix_cache),
                          [(pa, 0.0, 0, 0), (pb, 0.0, 0, 0)], n=8)
    (ind, _), (got, st) = run(False), run(True)
    assert got == ind
    kv = st["kv"]
    assert kv["prefix_hits"] == 1 and kv["prefix_tokens_saved"] >= 64
    assert kv["cow_copies"] == 1 and kv["blocks_in_use"] == 0


def test_slot_reclaim_releases_kv_blocks(tiny):
    """Claim, free and re-claim return the pool to its baseline; with the
    prefix cache the released blocks park on the evictable LRU, still
    allocatable."""
    _, net = tiny
    for prefix_cache in (False, True):
        eng = DecodeEngine(net, slots=2, max_len=MAXLEN, kv="paged",
                           kv_block_size=16,
                           prefix_cache=prefix_cache).start()
        try:
            pool = eng._pool
            baseline = (pool.in_use, pool.free_count)
            for round_ in range(3):
                for p in prompts((17, 33), seed=round_):
                    eng.generate(p, max_new_tokens=10, timeout=120)
                assert (pool.in_use, pool.free_count) == baseline
                assert baseline[0] == 0
            assert (pool.cached_count > 0) == prefix_cache
        finally:
            eng.stop()
        assert pool.in_use == 0


def test_engine_stop_releases_inflight_blocks(tiny):
    _, net = tiny
    for prefix_cache in (False, True):
        eng = DecodeEngine(net, slots=2, max_len=MAXLEN, kv="paged",
                           kv_block_size=16,
                           prefix_cache=prefix_cache).start()
        futs = [eng.submit(p, max_new_tokens=40) for p in prompts((17, 9))]
        eng.stop()
        assert eng._pool.in_use == 0 and eng._pool.cached_count == 0
        for f in futs:
            assert f.done()


def test_cached_blocks_keep_block_zero_out_of_live_tables(tiny):
    """After a finished request published its prompt's three full blocks,
    two requests diverging inside the third claim the first two read-only
    and copy the third (copy-on-write): no live table row names block 0
    within its span, and the copies' sources are the published block."""
    _, net = tiny
    eng = DecodeEngine(net, slots=2, max_len=MAXLEN, kv="paged",
                       kv_block_size=8)
    stem = prompts((24,), seed=2)[0]
    first = _Request(stem, 4, 0, 0.0, 0, None)
    with eng._cv:
        eng._queue.append(first)
        eng._admit_locked()
    published = list(first.kv_blocks[:3])
    eng._free_slot(0, first)
    assert eng._pool.cached_count == 3 and eng._pool.in_use == 0
    tail = [(stem[19] + 1) % V, 2]
    reqs = [_Request(stem[:19] + tail, 20, 0, 0.0, 0, None)
            for _ in range(2)]
    with eng._cv:
        eng._queue.extend(reqs)
        eng._admit_locked()
    for i, r in enumerate(reqs):
        need = -(-(len(r.prompt) + r.max_new - 1) // 8)
        assert 0 not in r.kv_blocks and len(r.kv_blocks) == need
        assert r.kv_blocks[:2] == published[:2] and r.cursor == 19
        assert published[2] not in r.kv_blocks
        assert list(eng._tables[i, :need]) == r.kv_blocks
        assert not eng._tables[i, need:].any()
    assert eng._pending_cows == [(published[2], r.kv_blocks[2])
                                 for r in reqs]
    assert eng._pool.refcount(published[2]) == 2
    eng._free_slot(0, reqs[0])
    assert not eng._tables[0].any()


def test_paged_config_validation(tiny):
    """JAX test_kv.py's configuration errors, and the options the port
    refuses."""
    jnet, net = tiny
    with pytest.raises(ValueError, match="kv_block_size"):
        DecodeEngine(net, max_len=60, kv="paged", kv_block_size=16)
    with pytest.raises(ValueError, match="chunk_tokens"):
        DecodeEngine(net, max_len=64, chunk_tokens=8)
    with pytest.raises(ValueError, match="chunk_tokens"):
        DecodeEngine(net, max_len=64, kv="paged", chunk_tokens=0)
    with pytest.raises(ValueError, match="kv must be"):
        DecodeEngine(net, max_len=64, kv="virtual")
    with pytest.raises(ValueError, match="host_kv_bytes"):
        DecodeEngine(net, max_len=64, kv="paged", prefix_cache=False,
                     host_kv_bytes=1 << 20)
    lstm = port_of(jax_lstm(layers=1))
    with pytest.raises(ValueError, match="prefix_cache"):
        DecodeEngine(lstm, max_len=64, kv="paged")
    with pytest.raises(ValueError, match="prefix_cache"):
        JaxDecode(jax_lstm(layers=1), max_len=64, kv="paged")
    eng = DecodeEngine(lstm, max_len=64, kv="paged", prefix_cache=False)
    assert eng.kv == "paged"
    small = DecodeEngine(net, slots=1, max_len=64, kv="paged",
                         kv_block_size=16, kv_blocks=3, prefix_cache=False)
    with pytest.raises(ValueError, match="KV blocks"):
        small.submit(list(range(5)) * 8, max_new_tokens=20)


def test_chunked_lstm_engine_matches_the_plain_engine():
    """A recurrent model with chunked prefill (prefix cache off): the
    chunk scans the LSTMs' decode step, the tokens are the plain
    engine's, and the JAX engine's greedy ones."""
    jnet = jax_lstm()
    net = port_of(jnet)
    reqs = [(p, t, s, 0) for p in prompts((1, 6, 19), seed=5)
            for t, s in ((0.0, 0), (0.7, 3))]
    want, _ = run_engine(DecodeEngine(net, slots=3, max_len=48), reqs)
    kw = dict(slots=3, max_len=48, kv="paged", kv_block_size=16,
              prefix_cache=False, chunk_tokens=4)
    got, st = run_engine(DecodeEngine(net, **kw), reqs)
    assert got == want and st["kv"]["prefill_chunks"] > 0
    greedy = [q for q in reqs if q[1] == 0.0]
    jwant, _ = run_engine(JaxDecode(jnet, **kw), greedy)
    assert [g for g, q in zip(got, reqs) if q[1] == 0.0] == jwant
