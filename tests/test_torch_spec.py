"""The port's speculative decoding -- token trees, the acceptance rule,
the draft, the verify's ``tree_chunk`` / ``tree_commit`` and the carries'
rewind, self-drafting -- held against the JAX package's, on the CPU.

The models are the JAX tests' own (tests/test_spec.py): a 2 x LSTM(16)
char model with a 2 x LSTM(8) draft, a TinyTransformer (2 blocks,
d_model 32, 4 heads) with a 1-block d_model-16 draft, over a 13-token
vocabulary, built in the JAX package and carried across as numpy arrays.
Bars: the tree tables and walks equal; single layers within 1e-5; every
speculative engine's tokens identical to the port's plain engine (greedy
and seeded sampling, with top-k); greedy tokens and the drafted and
accepted counts equal to the JAX engine's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpec
from deeplearning4j_tpu.serving.spec import TreeSpec as JaxTree
from deeplearning4j_tpu.serving.spec import accept_length as jax_accept
from deeplearning4j_tpu.serving.spec import parse_kvec as jax_parse_kvec

from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.decode import generate_naive
from deeplearning4j_tpu_torch.serving.spec import (SpecConfig, TreeSpec,
                                                   accept_length, parse_kvec)
from test_torch_kv_prefix import (MAXLEN, V, _leaves, jax_lstm,
                                  jax_transformer, mha_pair, page_tables,
                                  recurrent_pair, run_engine)
from test_torch_regularised_training import port_of

ACT_TOL = 1e-5
KVECS = [(1, 1, 1, 1), (3, 2), (3, 2, 2)]
CASES = [([1, 2, 3], 0.0, 0, 0),          # greedy
         ([5], 0.0, 0, 0),                # one-token prompt: verify wipes
         ([0, 4, 2, 9, 7], 0.9, 123, 0),  # seeded sampling
         ([3, 3], 0.7, 7, 5)]             # sampling and a top-k filter
GREEDY = [c for c in CASES if c[1] == 0.0] + [(list(range(1, 12)), 0.0, 0,
                                                0)]


@pytest.fixture(scope="module")
def lstms():
    """(JAX target, port target, JAX draft, port draft)."""
    jt, jd = jax_lstm(), jax_lstm(seed=11, width=8)
    return jt, port_of(jt), jd, port_of(jd)


@pytest.fixture(scope="module")
def tinies():
    jt, jd = jax_transformer(), jax_transformer(seed=3, n_layers=1,
                                                d_model=16, n_heads=2)
    return jt, port_of(jt), jd, port_of(jd)


def spec_run(net, spec=None, n=18, reqs=CASES, slots=4, max_len=48, **kw):
    return run_engine(DecodeEngine(net, slots=slots, max_len=max_len,
                                   spec=spec, **kw), reqs, n=n)


def _assert_spec_stats(st):
    sp = st["spec"]
    assert sp["drafted_tokens"] > 0 and 0.0 <= sp["acceptance_rate"] <= 1.0
    assert sp["verifies"] > 0 and sp["draft_calls"] > 0
    assert st["occupied_slots"] == 0
    if st["kv"] is not None:
        assert st["kv"]["blocks_in_use"] == 0


# --------------------------------------------------------- tree and rule

@pytest.mark.parametrize("kvec", KVECS)
def test_tree_tables_and_walk_match_jax(kvec):
    """The static tables, and the walk over random node tokens and oracle
    tokens (an alphabet of 3, so that matches are common) with budgets
    0..D+1, equal the JAX TreeSpec's."""
    tr, jtr = TreeSpec(kvec), JaxTree(kvec)
    assert (tr.n_nodes, tr.d, tr.kvec) == (jtr.n_nodes, jtr.d, jtr.kvec)
    for name in ("parent", "depth", "spine", "first", "anc_at_depth"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jtr, name))
    np.testing.assert_array_equal(tr.ancestor_matrix(),
                                  jtr.ancestor_matrix())
    r = np.random.RandomState(len(kvec))
    S = 256
    toks = r.randint(0, 3, (S, tr.n_nodes))
    oracle = r.randint(0, 3, (S, tr.n_nodes))
    n_in = r.randint(0, tr.d + 2, S)
    got = tr.walk(toks, oracle, n_in)
    want = jtr.walk(jnp.asarray(toks), jnp.asarray(oracle),
                    jnp.asarray(n_in))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].max() > 0
    # side-branch acceptances leave the spine count short
    assert (got[2] < got[0]).any() == (max(kvec) > 1)


def test_tree_walk_side_branches_and_budget():
    """JAX test_spec.py's walk case: a sibling covering a spine miss
    advances and ends the path; ``spine_acc`` counts the spine only."""
    tr = TreeSpec((2, 2))
    toks = np.array([[7, 5, 6, 8, 9]] * 4)
    oracle = np.array([[5, 8, 0, 1, 2], [6, 8, 0, 1, 2], [5, 9, 0, 1, 2],
                       [4, 8, 0, 1, 2]])
    a, emitted, spine_acc, path = tr.walk(toks, oracle, np.full(4, 3))
    assert a.tolist() == [2, 1, 2, 0] and emitted.tolist() == [3, 2, 3, 1]
    assert spine_acc.tolist() == [2, 0, 1, 0]
    assert path.tolist() == [[0, 1, 3], [0, 2, 2], [0, 1, 4], [0, 0, 0]]
    assert tr.walk(toks, oracle, np.ones(4, int))[1].tolist() == [1] * 4
    assert tr.walk(toks, oracle, np.zeros(4, int))[1].tolist() == [0] * 4


def test_parse_kvec_and_bad_trees():
    for text in ("3,2,2", "1", " 4, 1 "):
        assert parse_kvec(text) == jax_parse_kvec(text)
    for bad in ("", ","):
        with pytest.raises(ValueError):
            parse_kvec(bad)
    for bad in ((2, 0), ()):
        with pytest.raises(ValueError):
            TreeSpec(bad)


def test_accept_length_matches_jax():
    oracle = np.array([[5, 6, 7, 8]] * 4)
    draft = np.array([[5, 6, 9, 8], [5, 6, 7, 8], [9, 6, 7, 8], [5, 6, 7, 8]])
    a, e = accept_length(oracle, draft, np.array([4, 4, 4, 2]))
    assert a.tolist() == [2, 4, 0, 2] and e.tolist() == [3, 4, 1, 2]
    r = np.random.RandomState(0)
    for k in (1, 3, 6):
        o, d = r.randint(0, 2, (50, k)), r.randint(0, 2, (50, k))
        n = r.randint(0, k + 1, 50)
        for g, w in zip(accept_length(o, d, n),
                        jax_accept(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(n))):
            np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------ the layers

def _close(port, ref, tol=ACT_TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("kvec", [(1, 1, 1), (3, 2, 2)])
def test_attention_tree_chunk_and_commit_match_jax(kv, kvec):
    """A cache prefilled to 9/4/17 positions, then a tree at those
    positions: every node's output and K/V within 1e-5 of the JAX layer's,
    the cache untouched by ``tree_chunk``; then ``tree_commit`` of one
    path per row (2, 0 = inert and 3 depths): the caches within 1e-5 (the
    paged pool outside the scratch block)."""
    jl, jp, layer, pp = mha_pair()
    tr, jtr = TreeSpec(kvec), JaxTree(kvec)
    B, C, bs = 3, 32, 8
    r = np.random.RandomState(4)
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
    pos0 = np.array([9, 4, 17], np.int32)
    x = r.randn(B, 17, 32).astype(np.float32)
    z = np.zeros(B, np.int32)
    _, jd = jl.prefill_chunk(jp, jd, jnp.asarray(x), jnp.asarray(z),
                             jnp.asarray(pos0), **jkw)
    _, pd = layer.prefill_chunk(pp, pd, torch.tensor(x), torch.tensor(z),
                                torch.tensor(pos0), **pkw)
    before = {k: v.clone() for k, v in pd.items()}
    xn = r.randn(B, tr.n_nodes, 32).astype(np.float32)
    n_in = np.array([3, 0, tr.d + 1], np.int32)
    jy, _, _, jwin = jl.tree_chunk(jp, jd, jnp.asarray(xn),
                                   jnp.asarray(pos0), jtr,
                                   jnp.asarray(n_in), **jkw)
    py, pd2, stack, pwin = layer.tree_chunk(pp, pd, torch.tensor(xn),
                                            torch.tensor(pos0), tr,
                                            torch.tensor(n_in), **pkw)
    assert stack is None and pd2 is pd
    _close(py.numpy(), np.asarray(jy))
    for key in ("k", "v"):
        _close(pwin[key].numpy(), np.asarray(jwin[key]))
    for key in pd:
        assert torch.equal(pd[key], before[key])
    path = np.stack([tr.anc_at_depth[int(n)] for n in
                     (tr.spine[1], 0, tr.spine[tr.d])]).astype(np.int32)
    commit = np.array([2, 0, tr.d + 1], np.int32)
    jd = jl.tree_commit(jp, jd, jwin, jnp.asarray(path), jnp.asarray(pos0),
                        jnp.asarray(commit), **jkw)
    pd = layer.tree_commit(pp, pd, pwin, torch.tensor(path),
                           torch.tensor(pos0), torch.tensor(commit), **pkw)
    for key in pd:
        got, want = pd[key].numpy(), np.asarray(jd[key])
        if kv == "paged":
            got, want = got[1:], want[1:]
        _close(got, want)


@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM", "SimpleRnn"])
def test_recurrent_tree_chunk_stack_matches_jax(kind):
    """The base protocol over a recurrent layer: each node steps from its
    parent's carry; outputs and the node-indexed carry stack within 1e-5
    of the JAX layer's, the incoming carry unchanged."""
    jl, layer, jparams, pp, jd0, pd0 = recurrent_pair(kind, seed=5)
    tr, jtr = TreeSpec((3, 2, 2)), JaxTree((3, 2, 2))
    r = np.random.RandomState(6)
    B = 3
    xn = r.randn(B, tr.n_nodes, 6).astype(np.float32)
    pos0, n = np.array([0, 5, 9], np.int32), np.array([4, 1, 0], np.int32)
    jy, _, jst, jwin = jl.tree_chunk(jparams, jd0, jnp.asarray(xn),
                                     jnp.asarray(pos0), jtr, jnp.asarray(n))
    py, pd, pst, pwin = layer.tree_chunk(pp, pd0, torch.tensor(xn),
                                         torch.tensor(pos0), tr,
                                         torch.tensor(n))
    assert pd is pd0 and pwin is None and jwin is None
    _close(py.numpy(), np.asarray(jy))
    for got, want in zip(_leaves(pst), _leaves(jst)):
        assert tuple(got.shape) == (tr.n_nodes, B, 8)
        _close(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- the engines

LSTM_SPECS = {"k2": dict(k=2), "k4": dict(k=4), "tree32": dict(tree=(3, 2)),
              "early_exit": dict(k=3, self_draft="early_exit:1")}


@pytest.mark.parametrize("name", sorted(LSTM_SPECS))
def test_spec_matches_plain_charlstm(lstms, name):
    """Over recurrent carries (snapshot rewind, and the draft's resync
    after a side-branch acceptance for the tree): the plain engine's
    tokens, greedy and sampled."""
    _, net, _, draft = lstms
    kw = dict(LSTM_SPECS[name])
    spec = SpecConfig(None if "self_draft" in kw else draft, **kw)
    want, _ = spec_run(net)
    got, st = spec_run(net, spec)
    assert got == want
    _assert_spec_stats(st)
    assert st["spec"]["tree"] == list(spec.kvec())
    assert st["spec"]["self_draft"] == spec.self_draft


TINY_KV = {"dense": dict(kv="dense"),
           "paged": dict(kv="paged", kv_block_size=16, prefix_cache=False),
           "paged-prefix": dict(kv="paged", kv_block_size=16)}


@pytest.mark.parametrize("tree", [None, (3, 2, 2)], ids=["k4", "tree322"])
@pytest.mark.parametrize("kv", sorted(TINY_KV))
def test_spec_matches_plain_transformer(tinies, kv, tree):
    """Over positional KV (rejected rows never written, the accepted path
    committed), dense and paged, with and without the prefix cache:
    the plain engine's tokens."""
    _, net, _, draft = tinies
    want, _ = spec_run(net, max_len=MAXLEN, **TINY_KV[kv])
    got, st = spec_run(net, SpecConfig(draft, k=4, tree=tree),
                       max_len=MAXLEN, **TINY_KV[kv])
    assert got == want
    _assert_spec_stats(st)


def test_spec_with_chunked_prefill_and_the_target_as_draft(tinies):
    """Chunked prefill and speculation compose (the chunk consumes the
    prompt, the draft catches up beside it); the target as its own draft
    accepts nearly everything and commits D+1 tokens a verify."""
    _, net, _, draft = tinies
    kv = dict(kv="paged", kv_block_size=16, chunk_tokens=4)
    want, _ = spec_run(net, max_len=MAXLEN, **kv)
    got, st = spec_run(net, SpecConfig(draft, k=4), max_len=MAXLEN, **kv)
    assert got == want and st["kv"]["prefill_chunks"] > 0
    got, st = spec_run(net, SpecConfig(net, k=4), max_len=MAXLEN, **kv)
    assert got == want
    assert st["spec"]["mean_accepted_depth"] > 3.0
    assert st["spec"]["acceptance_rate"] > 0.8


def test_greedy_tokens_and_counts_equal_the_jax_engine(lstms, tinies):
    """Greedy requests one at a time through a speculative engine in both
    packages (LSTM k=4 dense; TinyTransformer tree (3, 2, 2) paged with
    the prefix cache): the same tokens, drafted and accepted counts."""
    jt, net, jd, draft = lstms
    cases = [(jt, net, JaxSpec(jd, k=4), SpecConfig(draft, k=4), 48, {})]
    jt2, net2, jd2, draft2 = tinies
    cases.append((jt2, net2, JaxSpec(jd2, tree=(3, 2, 2)),
                  SpecConfig(draft2, tree=(3, 2, 2)), MAXLEN,
                  dict(kv="paged", kv_block_size=16)))
    for jnet, pnet, jspec, pspec, max_len, kw in cases:
        want, jst = run_engine(JaxDecode(jnet, slots=4, max_len=max_len,
                                         spec=jspec, **kw), GREEDY, n=18)
        got, st = spec_run(pnet, pspec, reqs=GREEDY, max_len=max_len, **kw)
        assert got == want
        for key in ("drafted_tokens", "accepted_tokens", "k", "tree",
                    "tree_nodes", "acceptance_rate"):
            assert st["spec"][key] == jst["spec"][key], key


def test_acceptance_rate_zero_before_any_draft(lstms):
    _, net, _, draft = lstms
    eng = DecodeEngine(net, slots=2, max_len=48,
                       spec=SpecConfig(draft, k=3)).start()
    try:
        st = eng.stats()["spec"]
        assert st["drafted_tokens"] == 0 and st["acceptance_rate"] == 0.0
        assert st["mean_accepted_depth"] == 0.0
        assert eng._m_spec_rate.value == 0.0
    finally:
        eng.stop()


def test_spec_arrival_schedule_invariance(lstms):
    """The same requests one at a time and as a burst (slots share the
    draft and verify calls): the same tokens."""
    _, net, _, draft = lstms
    eng = DecodeEngine(net, slots=4, max_len=48,
                       spec=SpecConfig(draft, k=4)).start()
    try:
        seq = [eng.generate(p, max_new_tokens=18, seed=s, temperature=t,
                            top_k=k, timeout=120)["tokens"]
               for p, t, s, k in CASES]
        futs = [eng.submit(p, max_new_tokens=18, seed=s, temperature=t,
                           top_k=k) for p, t, s, k in CASES]
        assert [f.result(timeout=120)["tokens"] for f in futs] == seq
    finally:
        eng.stop()


@pytest.mark.parametrize("prefix_cache,tree", [
    (False, None), (True, None), (True, (2, 2))],
    ids=["no-prefix", "prefix", "prefix-tree"])
def test_fully_rejected_windows_rewind_bitwise_paged(tinies, prefix_cache,
                                                     tree):
    """JAX test_spec.py's rewind case: a draft whose proposals never match
    forces every verify to emit the correction token alone. The stream is
    still the plain engine's, also for a second request that claims the
    prefix blocks the first published (rejected rows are neither read nor
    published)."""
    _, net, _, draft = tinies
    kv_kw = dict(kv="paged", kv_block_size=4, prefix_cache=prefix_cache)
    prompt = [0, 4, 2, 9, 7, 1]
    (ref,), _ = run_engine(DecodeEngine(net, slots=2, max_len=MAXLEN,
                                        **kv_kw), [(prompt, 0.0, 0, 0)],
                           n=20)
    wrong = sorted(set(range(V)) - set(ref))[0]
    spec = DecodeEngine(net, slots=2, max_len=MAXLEN,
                        spec=SpecConfig(draft, k=4, tree=tree),
                        **kv_kw).start()
    real_step = spec._draft.step

    def adversarial_step(*args, **kw):
        # the proposals are resident tensors the verify reads in place
        props, sides = real_step(*args, **kw)
        props.fill_(wrong)
        sides.fill_(wrong)
        return props, sides

    spec._draft.step = adversarial_step
    try:
        for _ in range(2):
            out = spec.generate(prompt, max_new_tokens=20, timeout=120)
            assert out["tokens"] == ref
        st = spec.stats()
        assert st["spec"]["accepted_tokens"] == 0
        assert st["spec"]["drafted_tokens"] > 0
        assert st["spec"]["acceptance_rate"] == 0.0
        assert st["spec"]["mean_accepted_depth"] == 0.0
        if prefix_cache:
            assert st["kv"]["prefix_hits"] >= 1
    finally:
        spec.stop()


def test_generate_naive_shares_the_sampling_oracle(lstms):
    _, net, _, _ = lstms
    eng = DecodeEngine(net, slots=2, max_len=48).start()
    try:
        for temp, seed, tk in [(0.0, 0, 0), (0.8, 42, 0), (0.6, 9, 4)]:
            naive = generate_naive(net, [1, 2, 3], 12, 48, seed=seed,
                                   temperature=temp, top_k=tk)
            served = eng.generate([1, 2, 3], max_new_tokens=12, seed=seed,
                                  temperature=temp, top_k=tk, timeout=120)
            assert naive["tokens"] == served["tokens"]
    finally:
        eng.stop()


def test_spec_config_validation(lstms, tinies):
    """JAX test_spec.py's configuration errors, with the same messages."""
    _, net, _, draft = lstms

    def build(**kw):
        return DecodeEngine(net, slots=2, max_len=48, spec=SpecConfig(**kw))
    with pytest.raises(ValueError, match="spec.k"):
        build(draft_model=draft, k=0)

    class _Vocab:
        size = V + 1

    class _Conf:
        input_type = _Vocab()

    class _BadDraft:
        conf = _Conf()

    with pytest.raises(ValueError, match="vocabulary"):
        build(draft_model=_BadDraft(), k=4)
    with pytest.raises(ValueError, match="exactly one"):
        build(k=4)
    with pytest.raises(ValueError, match="exactly one"):
        build(draft_model=draft, k=4, self_draft="int8")
    with pytest.raises(ValueError, match="self_draft"):
        build(self_draft="int7")
    with pytest.raises(ValueError, match="positive layer count"):
        build(self_draft="early_exit:0")
    with pytest.raises(ValueError, match="out of range"):
        build(self_draft="early_exit:9")
    with pytest.raises(ValueError, match="conflicts"):
        build(self_draft="int8", draft_precision="fp8")
    with pytest.raises(ValueError, match="kvec"):
        build(draft_model=draft, tree=(2, 0))
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        DecodeEngine(tinies[1], slots=2, max_len=MAXLEN,
                     spec=SpecConfig(self_draft="early_exit:1"))
