"""The decode engine's programs -- the sampling rule as tensor code, one
program per signature over resident state, ``warmup()``, ``trace_count``,
``eos_id`` and ``swap_weights`` -- held against the JAX package's engine,
on the CPU.

The models are small: TinyTransformer with 2 blocks of d_model 32 and 2
heads (max_len 64, a 13-token vocabulary, a 1-block d_model-16 draft), and
a 2 x LSTM(16) char model, built in the JAX package and carried across as
numpy arrays (``params_from_numpy``). Tolerances: tokens exactly (greedy
against the JAX engine; sampled against the port's ``generate_naive``,
which shares the rule); the hash bits and the uniforms exactly against a
plain Python reference; the Gumbel values within 2e-6 relative of a
float64 reference; state leaves bit for bit (``torch.equal``).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpec
from deeplearning4j_tpu.serving.spec.accept import \
    oracle_tokens as jax_oracle_tokens

from deeplearning4j_tpu_torch.exec import ResidentProgram, get_executor
from deeplearning4j_tpu_torch.nn.layers.base import map_tree
from deeplearning4j_tpu_torch.resilience import WeightSwapError
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.decode import generate_naive
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from deeplearning4j_tpu_torch.serving.spec.accept import (
    draw_bits, gumbel, oracle_tokens, uniform_from_bits)
from test_torch_kv_prefix import (MAXLEN, V, jax_lstm, jax_transformer,
                                  run_engine)
from test_torch_regularised_training import port_of

GUMBEL_RTOL = 2e-6
GREEDY = [([1, 2, 3], 0.0, 0, 0), ([5], 0.0, 0, 0),
          (list(range(1, 12)), 0.0, 0, 0), ([7, 7, 2, 9], 0.0, 0, 0)]
SAMPLED = [([0, 4, 2, 9, 7], 0.9, 123, 0), ([3, 3], 0.7, 7, 5),
           ([6], 1.3, 2 ** 32 - 1, 0)]


@pytest.fixture(scope="module")
def tinies():
    """(JAX target, port target, JAX draft, port draft): 2 blocks of
    d_model 32 and 2 heads, and a 1-block d_model-16 draft."""
    jt = jax_transformer(n_heads=2)
    jd = jax_transformer(seed=3, n_layers=1, d_model=16, n_heads=2)
    return jt, port_of(jt), jd, port_of(jd)


@pytest.fixture(scope="module")
def lstms():
    jt = jax_lstm()
    return jt, port_of(jt)


# ------------------------------------------------------------ the rule

def _ref_bits(seed, pos, tok):
    """The draw's hash in Python integers (no overflow anywhere)."""
    M = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & M
        x ^= x >> 15
        x = (x * 0x31848BAB) & M
        return x ^ (x >> 16)
    h = mix((seed + 0x9E3779B9) & M)
    h = mix(h ^ (pos & M))
    return mix(h ^ tok)


def test_greedy_oracle_tokens_equal_jax():
    """Random (S, V) log-probabilities on a coarse grid (many ties), with
    top-k 0 (none), 1, 3 and V + 5: the argmax of the filtered row, ties
    to the lowest id, equals the JAX rule's token for token."""
    r = np.random.RandomState(0)
    S, Vb = 64, 37
    logits = np.log(r.randint(1, 6, (S, Vb)).astype(np.float32) / 10)
    seeds = r.randint(0, 2 ** 31, S)
    pos = r.randint(0, 500, S)
    for topk in (0, 1, 3, Vb + 5):
        tk = np.full(S, topk)
        temps = np.zeros(S, np.float32)
        got = oracle_tokens(torch.tensor(logits), torch.tensor(seeds),
                            torch.tensor(pos), torch.tensor(temps),
                            torch.tensor(tk)).numpy()
        want = np.asarray(jax_oracle_tokens(
            jnp.asarray(logits), jnp.asarray(seeds.astype(np.uint32)),
            jnp.asarray(pos.astype(np.int32)), jnp.asarray(temps),
            jnp.asarray(tk.astype(np.int32))))
        np.testing.assert_array_equal(got, want)


def test_sampled_draw_is_the_reference_hash():
    """The hash bits and the uniforms equal a plain Python reference bit
    for bit (seeds up to 2**32 - 1); the Gumbel noise is within
    GUMBEL_RTOL of float64; the sampled token is the argmax of the
    filtered row over the temperature plus that noise."""
    r = np.random.RandomState(1)
    seeds = np.concatenate([[0, 1, 2 ** 31, 2 ** 32 - 1],
                            r.randint(0, 2 ** 32 - 1, 12, dtype=np.int64)])
    pos = r.randint(0, 1 << 20, seeds.size)
    Vb = 41
    bits = draw_bits(torch.tensor(seeds)[:, None], torch.tensor(pos)[:, None],
                     torch.arange(Vb)[None, :]).numpy()
    want = np.array([[_ref_bits(int(s), int(p), t) for t in range(Vb)]
                     for s, p in zip(seeds, pos)], np.int64)
    np.testing.assert_array_equal(bits, want)
    u = uniform_from_bits(torch.tensor(bits)).numpy()
    np.testing.assert_array_equal(
        u, ((2 * (want >> 9) + 1) * 2.0 ** -24).astype(np.float32))
    assert u.min() > 0 and u.max() < 1
    g = gumbel(torch.tensor(seeds), torch.tensor(pos), Vb).numpy()
    g64 = -np.log(-np.log(u.astype(np.float64)))
    np.testing.assert_allclose(g, g64, rtol=GUMBEL_RTOL, atol=GUMBEL_RTOL)
    logits = np.log(r.dirichlet(np.ones(Vb), seeds.size)).astype(np.float32)
    temps = np.full(seeds.size, 0.8, np.float32)
    got = oracle_tokens(torch.tensor(logits), torch.tensor(seeds),
                        torch.tensor(pos), torch.tensor(temps),
                        torch.zeros(seeds.size, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits / 0.8 + g, axis=1))


def test_sampled_draw_does_not_depend_on_slot_or_arrival():
    """The same (distribution, seed, position) row gives the same token in
    any slot and beside any other rows; another seed or position draws
    anew."""
    r = np.random.RandomState(2)
    S, Vb = 16, 29
    logits = torch.tensor(np.log(r.dirichlet(np.ones(Vb), S)),
                          dtype=torch.float32)
    seeds = torch.tensor(r.randint(0, 2 ** 31, S))
    pos = torch.tensor(r.randint(0, 300, S))
    temps = torch.full((S,), 1.0)
    topk = torch.tensor(r.randint(0, 6, S))
    base = oracle_tokens(logits, seeds, pos, temps, topk)
    perm = torch.tensor(r.permutation(S))
    np.testing.assert_array_equal(
        oracle_tokens(logits[perm], seeds[perm], pos[perm], temps[perm],
                      topk[perm]), base[perm])
    for i in range(S):
        one = oracle_tokens(logits[i:i + 1], seeds[i:i + 1], pos[i:i + 1],
                            temps[i:i + 1], topk[i:i + 1])
        assert int(one[0]) == int(base[i])
    draws = {int(oracle_tokens(logits[:1], seeds[:1] + s, pos[:1],
                               temps[:1], torch.zeros(1, dtype=torch.long))[0])
             for s in range(40)}
    assert len(draws) > 1


# ------------------------------------------------------------ the engines

def _engine_cases(tinies, lstms):
    jt, pt, jd, pd = tinies
    jl, pl = lstms
    pg = dict(kv="paged", kv_block_size=16)
    return {
        "dense": (jt, pt, {}, {}),
        "paged": (jt, pt, pg, pg),
        "paged-chunk": (jt, pt, dict(pg, chunk_tokens=8),
                        dict(pg, chunk_tokens=8)),
        "spec-tree-dense": (jt, pt,
                            dict(spec=JaxSpec(jd, tree=(3, 2, 2))),
                            dict(spec=SpecConfig(pd, tree=(3, 2, 2)))),
        "spec-linear-paged-chunk": (
            jt, pt, dict(pg, chunk_tokens=8, spec=JaxSpec(jd, k=4)),
            dict(pg, chunk_tokens=8, spec=SpecConfig(pd, k=4))),
        "lstm-self-draft": (
            jl, pl, dict(spec=JaxSpec(self_draft="early_exit:1",
                                      tree=(3, 2))),
            dict(spec=SpecConfig(self_draft="early_exit:1", tree=(3, 2))))}


CASE_NAMES = ["dense", "paged", "paged-chunk", "spec-tree-dense",
              "spec-linear-paged-chunk", "lstm-self-draft"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_engine_tokens_equal_jax_greedy_and_naive_sampled(tinies, lstms,
                                                          name):
    """Greedy requests, submitted together: the port's tokens equal the
    JAX engine's. Seeded sampling with top-k: the port's tokens equal its
    ``generate_naive``'s. One program each, no block in use at the end."""
    jnet, net, jkw, pkw = _engine_cases(tinies, lstms)[name]
    kw = dict(slots=3, max_len=MAXLEN)
    want, _ = run_engine(JaxDecode(jnet, **kw, **jkw), GREEDY, n=12,
                         concurrent=True)
    eng = DecodeEngine(net, **kw, **pkw)
    got, st = run_engine(eng, GREEDY + SAMPLED, n=12, concurrent=True)
    assert got[:len(GREEDY)] == want
    naive = [generate_naive(net, p, 12, MAXLEN, seed=s, temperature=t,
                            top_k=k)["tokens"] for p, t, s, k in SAMPLED]
    assert got[len(GREEDY):] == naive
    assert eng.trace_count == 1 and st["compiled_programs"] == 1
    assert all(p["programs"] == 1 for p in eng.program_stats().values())
    if st["kv"] is not None:
        assert st["kv"]["blocks_in_use"] == 0
    if st["spec"] is not None:
        assert st["spec"]["verify_programs"] == 1
        assert st["spec"]["draft_programs"] == 1


def test_eos_ends_the_stream_as_in_jax(lstms, tinies):
    """JAX test_decode.py's eos case: a stream ends when it emits
    ``eos_id`` (emitted, then the slot is freed). The plain and the
    speculative engines (the accepted run cut at its first ``eos_id``)
    give the JAX engine's tokens with the same ``eos_id``."""
    jnet, net = lstms
    prompt = [1, 2, 3]
    full, _ = run_engine(DecodeEngine(net, slots=2, max_len=24),
                         [(prompt, 0.0, 0, 0)], n=10)
    eos = full[0][3]
    want = full[0][:full[0].index(eos) + 1]
    assert len(want) < 10
    (jtoks,), _ = run_engine(JaxDecode(jnet, slots=2, max_len=24,
                                       eos_id=eos), [(prompt, 0.0, 0, 0)],
                             n=10)
    assert jtoks == want
    for kw in ({}, dict(spec=SpecConfig(self_draft="early_exit:1",
                                        tree=(3, 2)))):
        eng = DecodeEngine(net, slots=2, max_len=24, eos_id=eos, **kw)
        (got,), st = run_engine(eng, [(prompt, 0.0, 0, 0)], n=10)
        assert got == want and got[-1] == eos
        assert st["occupied_slots"] == 0 and st["requests"] == 1
    # the transformer's paged engine releases the stream's blocks
    jt, pt, _, _ = tinies
    full, _ = run_engine(DecodeEngine(pt, slots=2, max_len=MAXLEN),
                         [(prompt, 0.0, 0, 0)], n=10)
    eos = full[0][2]
    eng = DecodeEngine(pt, slots=2, max_len=MAXLEN, eos_id=eos, kv="paged",
                       kv_block_size=16)
    (got,), st = run_engine(eng, [(prompt, 0.0, 0, 0)], n=10)
    assert got == full[0][:full[0].index(eos) + 1]
    assert st["kv"]["blocks_in_use"] == 0


def test_one_program_after_staggered_work_and_a_soak(lstms):
    """JAX test_decode.py's trace-count pins: requests arriving staggered
    from threads, then a soak of 64 random requests, run through ONE step
    program (``trace_count == 1``, ``compiled_programs == 1``)."""
    _, net = lstms
    eng = DecodeEngine(net, slots=4, max_len=32).start()
    try:
        prompts = [[1, 2], [3], [4, 5, 6], [7, 8], [9], [10, 11, 12]]
        solo = [eng.generate(p, max_new_tokens=6) for p in prompts]
        results = {}

        def worker(i, p):
            time.sleep(0.002 * i)
            results[i] = eng.generate(p, max_new_tokens=6, timeout=120)
        threads = [threading.Thread(target=worker, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [results[i]["tokens"] for i in range(len(prompts))] == \
            [r["tokens"] for r in solo]
        assert eng.trace_count == 1
        rs = np.random.RandomState(5)
        futs = [eng.submit(list(rs.randint(0, V, int(rs.randint(1, 12)))),
                           max_new_tokens=int(rs.randint(1, 16)), seed=i,
                           temperature=float(rs.rand())) for i in range(64)]
        outs = [f.result(timeout=300) for f in futs]
        assert all(len(o["tokens"]) >= 1 for o in outs)
        assert eng.trace_count == 1
        st = eng.stats()
        assert st["compiled_programs"] == 1 and st["requests"] == 76
    finally:
        eng.stop()


def _randomize(tree, seed):
    gen = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen))
        else:
            t.copy_(torch.randint(0, V, t.shape, generator=gen))
        return t
    map_tree(fill, tree)


def test_warmup_leaves_the_state_bit_for_bit(tinies, lstms):
    """``warmup()`` runs every program inertly once (step, prefill chunk,
    copy-on-write, draft, verify) and leaves the decode state, the draft's
    state and its proposals bit for bit as it found them (here filled with
    random values); then every program is sealed with one signature."""
    _, pt, _, pd = tinies
    _, pl = lstms
    engines = [
        DecodeEngine(pt, slots=3, max_len=MAXLEN, kv="paged",
                     kv_block_size=16, chunk_tokens=8,
                     spec=SpecConfig(pd, tree=(3, 2, 2))),
        DecodeEngine(pl, slots=3, max_len=MAXLEN, kv="paged",
                     prefix_cache=False, chunk_tokens=8,
                     spec=SpecConfig(self_draft="early_exit:1", tree=(3, 2)))]
    for eng in engines:
        eng._ensure_state()
        state = [eng._dstate, eng._draft._tree, eng._draft.props,
                 eng._draft.sides]
        _randomize(state, 0)
        before = map_tree(lambda t: t.clone(), state)
        assert eng.warmup() >= 0.0
        map_tree(lambda a, b: (torch.equal(a, b) or pytest.fail(
            "warmup changed the state")), state, before)
        progs = eng.program_stats()
        want = {"step", "prefill", "draft", "verify"} | (
            {"cow"} if eng._prefix is not None else set())
        assert set(progs) == want
        assert all(p["programs"] == 1 for p in progs.values())
        assert eng.trace_count == 1
        assert all(p.sealed for p in eng._programs.values())


def test_programs_are_fixed_to_their_resident_tensors():
    """A program reads its resident tensors by address: another tensor in
    their place raises; a sealed program refuses a new signature; the
    programs count the signatures seen."""
    seen = []
    state = torch.zeros(3)

    def fn(res, buf):
        res["s"].add_(buf[:3].float())
        return res["s"].sum()
    prog = ResidentProgram(get_executor(), fn, "probe",
                           on_program=lambda: seen.append(1))
    prog({"s": state}, torch.ones(4, dtype=torch.int32))
    prog({"s": state}, torch.ones(4, dtype=torch.int32))
    assert state.tolist() == [2.0, 2.0, 2.0] and prog.programs == 1
    with pytest.raises(ValueError, match="resident"):
        prog({"s": torch.zeros(3)}, torch.ones(4, dtype=torch.int32))
    prog({"s": state}, torch.ones(5, dtype=torch.int32))
    assert prog.programs == 2 and len(seen) == 2
    prog.seal()
    with pytest.raises(RuntimeError, match="after warmup"):
        prog({"s": state}, torch.ones(6, dtype=torch.int32))


# ----------------------------------------------------------- the weights

def test_swap_weights_defers_and_equals_the_jax_swap(lstms):
    """A swap applies at the first tick boundary with no live slot: the
    stream in flight ends on the old weights, a request submitted while
    the swap is pending runs on the new ones; the version bumps, with no
    new program. The tokens after the swap equal the JAX engine's after
    the same swap."""
    jnet, net = lstms
    jnew = jax_lstm(seed=21)
    new = port_of(jnew)
    prompt = [1, 2, 3]
    old_want = generate_naive(net, prompt, 20, 32)["tokens"]
    new_want = generate_naive(new, prompt, 6, 32)["tokens"]
    assert old_want[:6] != new_want
    eng = DecodeEngine(net, slots=2, max_len=32).start()
    try:
        f1 = eng.submit(prompt, max_new_tokens=20)
        while eng.stats()["occupied_slots"] == 0 and not f1.done():
            time.sleep(0.001)
        done = {}
        t = threading.Thread(target=lambda: done.setdefault(
            "v", eng.swap_weights(new.params)))
        t.start()
        while eng._pending_swap is None and "v" not in done:
            time.sleep(0.001)
        f2 = eng.submit(prompt, max_new_tokens=6)
        t.join(timeout=120)
        assert f1.result(timeout=120)["tokens"] == old_want
        assert f2.result(timeout=120)["tokens"] == new_want
        assert done["v"] == 1 == eng.model_version
        assert eng.trace_count == 1
        st = eng.stats()
        assert st["model_version"] == 1 and st["compiled_programs"] == 1
    finally:
        eng.stop()
    jeng = JaxDecode(jnet, slots=2, max_len=32).start()
    try:
        jeng.swap_weights(jnew.params)
        want = [jeng.generate(p, max_new_tokens=8)["tokens"]
                for p, *_ in GREEDY[:3]]
    finally:
        jeng.stop()
    eng = DecodeEngine(net, slots=2, max_len=32)
    assert eng.swap_weights(new.params, version=7) == 7
    got, _ = run_engine(eng, GREEDY[:3], n=8)
    assert got == want


def test_a_mismatched_swap_raises_and_leaves_the_engine_untouched(lstms):
    jnet, net = lstms
    eng = DecodeEngine(net, slots=2, max_len=32)
    before, _ = run_engine(eng, GREEDY[:2], n=6)
    bad = [dict(p) for p in net.params]
    bad[0]["W"] = torch.zeros(3, 3)
    with pytest.raises(WeightSwapError, match="0/W"):
        eng.swap_weights(bad)
    missing = [dict(p) for p in net.params]
    del missing[1]["b"]
    with pytest.raises(WeightSwapError, match="missing"):
        eng.swap_weights(missing)
    with pytest.raises(WeightSwapError):
        eng.swap_weights(net.params, state={"x": np.zeros(2)})
    assert eng.model_version == 0 and eng._pending_swap is None
    again, _ = run_engine(eng, GREEDY[:2], n=6)
    assert again == before


def test_swap_clears_the_prefix_cache(tinies):
    """Cached KV was computed under the old weights: a swap drops every
    cached block, and the next request with the same prompt hits
    nothing."""
    jt, pt, _, _ = tinies
    new = port_of(jax_transformer(seed=17, n_heads=2))
    prompt = list(range(1, 13)) * 3
    eng = DecodeEngine(pt, slots=2, max_len=MAXLEN, kv="paged",
                       kv_block_size=16)
    _, st = run_engine(eng, [(prompt, 0.0, 0, 0)], n=4)
    assert st["kv"]["blocks_cached"] > 0
    eng.swap_weights(new.params)
    assert eng.stats()["kv"]["blocks_cached"] == 0
    (got,), st2 = run_engine(eng, [(prompt, 0.0, 0, 0)], n=4)
    assert st2["kv"]["prefix_hits"] == st["kv"]["prefix_hits"]
    assert got == generate_naive(new, prompt, 4, MAXLEN)["tokens"]


def test_the_engine_follows_fit_until_the_first_swap(lstms):
    """A freshly built engine follows further ``fit()`` calls on its model
    (the engine's parameter set is refreshed in place when the model's
    moved); after a swap it serves the swapped weights whatever the model
    does."""
    jnet, _ = lstms
    net = port_of(jnet)
    r = np.random.RandomState(3)
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[r.randint(0, V, (4, 8))], eye[r.randint(0, V, (4, 8))]
    prompt = [2, 4, 6]
    eng = DecodeEngine(net, slots=2, max_len=32).start()
    try:
        first = eng.generate(prompt, max_new_tokens=8)["tokens"]
        assert first == generate_naive(net, prompt, 8, 32)["tokens"]
        for _ in range(30):
            net.fit(x, y)
        after = eng.generate(prompt, max_new_tokens=8)["tokens"]
        assert after == generate_naive(net, prompt, 8, 32)["tokens"]
        assert after != first
        swapped = port_of(jax_lstm(seed=21))
        eng.swap_weights(swapped.params)
        net.fit(x, y)
        got = eng.generate(prompt, max_new_tokens=8)["tokens"]
        assert got == generate_naive(swapped, prompt, 8, 32)["tokens"]
        assert eng.trace_count == 1
    finally:
        eng.stop()
