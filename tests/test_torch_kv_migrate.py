"""KV block-chain migration in the port (``serving/kv/migrate.py``,
``DecodeEngine.kv_export`` / ``kv_import``) held against the JAX
package's, on the CPU.

The model is the JAX tests' own (TinyTransformer with a 13-token
vocabulary, d_model 32, 4 heads, 2 blocks, kv_block_size 8), built in the
JAX package and carried across as numpy arrays. Pinned here:

- the wire is the JAX package's byte for byte: ``pack_chain`` of the same
  rows gives the same JSON, checksum included, each package unpacks the
  other's, and every JAX rejection reason is raised on the same tampered
  payload;
- ``model_signature`` and the leaf paths are the JAX engine's, so a chain
  exported by the JAX engine imports into the port's and the reverse, and
  the continued greedy decode equals the exporter's;
- a migrated chain continues bit for bit (a mid-chain copy-on-write chain
  too); a rejected payload leaves the destination pool as it was and is
  counted under its reason;
- imports write the pool tensors in place (every leaf keeps its
  ``data_ptr()``) and add no program.
"""

import copy
import json

import numpy as np
import pytest

from deeplearning4j_tpu.exec.aot import model_signature as jax_model_sig
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.kv import KVMigrateError as JaxKVError
from deeplearning4j_tpu.serving.kv import pack_chain as jax_pack
from deeplearning4j_tpu.serving.kv import unpack_chain as jax_unpack
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch.monitor import get_registry
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.engine import model_signature
from deeplearning4j_tpu_torch.serving.kv import (KVMigrateError, pack_chain,
                                                 unpack_chain)
from test_torch_kv_prefix import jax_lstm
from test_torch_regularised_training import port_of

V, MAXLEN, BS = 13, 64, 8


def jax_tiny(seed=7, n_layers=2, d_model=32):
    return JaxTiny(vocab_size=V, n_layers=n_layers, d_model=d_model,
                   n_heads=4, max_len=MAXLEN, seed=seed).init()


@pytest.fixture(scope="module")
def tiny():
    jnet = jax_tiny()
    return jnet, port_of(jnet)


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, V, size=n))) for n in sizes]


def _kw(bs=BS, **kw):
    return dict(dict(slots=2, max_len=MAXLEN, kv="paged", kv_block_size=bs,
                     prefix_cache=True, chunk_tokens=8), **kw)


def _paged(net, **kw):
    return DecodeEngine(net, **_kw(**kw)).start()


def _snapshot(eng):
    p = eng._pool
    return (p.in_use, p.free_count, p.cached_count)


def _rejects(eng, reason):
    fam = get_registry().get("dl4jtpu_kv_migrate_rejects_total")
    return sum(c.value for key, c in fam.children()
               if key == (eng.id, reason))


def _wire(payload):
    """A deep copy through JSON, what a wire transfer does."""
    return json.loads(json.dumps(payload))


# --------------------------------------------------------------- the wire

def _rows(seed=0, n=2, dtype=np.float32):
    r = np.random.RandomState(seed)
    return {f"['b{i}_attn']['p{k}']": r.randn(n, BS, 4, 8).astype(dtype)
            for i in range(2) for k in "kv"}


ENVELOPE = {"model_sig": "0123abcd" * 4, "precision": "f32",
            "block_size": BS, "vocab": V}


def test_pack_chain_is_the_jax_wire_byte_for_byte():
    rows = _rows()
    tokens = _prompts([2 * BS])[0]
    mine, theirs = (pack_chain(rows, tokens, ENVELOPE),
                    jax_pack(rows, tokens, ENVELOPE))
    assert mine == theirs
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    for unpack, payload in ((unpack_chain, theirs), (jax_unpack, mine)):
        toks, got = unpack(_wire(payload), ENVELOPE, rows)
        assert toks == tokens
        assert sorted(got) == sorted(rows)
        assert all(np.array_equal(got[k], rows[k]) for k in rows)
    with pytest.raises(KVMigrateError) as e:
        pack_chain(rows, tokens[:-1], ENVELOPE)
    assert e.value.reason == "tokens"


def _tamper_b64(p):
    p["leaves"][0]["data"] = "!" + p["leaves"][0]["data"][1:]


def _tamper_checksum(p):
    d = p["leaves"][0]["data"]
    p["leaves"][0]["data"] = d[:-8] + ("AAAAAAA=" if d[-8:] != "AAAAAAA="
                                       else "BBBBBBA=")


TAMPERS = {
    "format": ("format", lambda p: p.update(format="v0")),
    "not_a_dict": ("format", None),
    "model_sig": ("model_sig", lambda p: p.update(model_sig="ff" * 16)),
    "precision": ("precision", lambda p: p.update(precision="int8")),
    "block_size": ("block_size", lambda p: p.update(block_size=16)),
    "vocab": ("vocab", lambda p: p.update(vocab=V + 1)),
    "tokens_short": ("tokens", lambda p: p["tokens"].pop()),
    "tokens_range": ("tokens", lambda p: p["tokens"].__setitem__(0, V)),
    "n_blocks": ("tokens", lambda p: p.update(n_blocks=0)),
    "leaves_type": ("leaves", lambda p: p.update(leaves="x")),
    "leaves_set": ("leaves", lambda p: p["leaves"].pop()),
    "dtype": ("dtype", lambda p: [l.update(dtype="float64")
                                  for l in p["leaves"]]),
    "shape": ("shape", lambda p: p["leaves"][0].update(shape=[2, BS, 4, 4])),
    "torn_cut": ("torn", lambda p: p["leaves"][0].update(
        data=p["leaves"][0]["data"][:40])),
    "torn_b64": ("torn", _tamper_b64),
    "torn_checksum": ("torn", _tamper_checksum),
}


@pytest.mark.parametrize("case", sorted(TAMPERS))
def test_every_rejection_reason_is_the_jax_one(case):
    reason, tamper = TAMPERS[case]
    rows = _rows(1)
    payload = _wire(pack_chain(rows, _prompts([2 * BS], 1)[0], ENVELOPE))
    if tamper is None:
        payload = [payload]
    else:
        tamper(payload)
    with pytest.raises(KVMigrateError) as mine:
        unpack_chain(copy.deepcopy(payload), ENVELOPE, rows)
    with pytest.raises(JaxKVError) as theirs:
        jax_unpack(copy.deepcopy(payload), ENVELOPE, rows)
    assert mine.value.reason == theirs.value.reason == reason


def test_bfloat16_rows_travel_as_their_raw_words():
    """numpy has no bfloat16: the port moves such a leaf's 16-bit words
    labelled ``bfloat16``, the JAX wire's name and bytes."""
    import ml_dtypes
    import torch
    rows = _rows(2, dtype=ml_dtypes.bfloat16)
    tokens = _prompts([2 * BS], 2)[0]
    theirs = jax_pack(rows, tokens, ENVELOPE)
    words = {k: v.view(np.uint16) for k, v in rows.items()}
    mine = pack_chain(words, tokens, ENVELOPE,
                      dtypes={k: "bfloat16" for k in words})
    assert mine == theirs
    leaves = {k: torch.zeros((5,) + v.shape[1:], dtype=torch.bfloat16)
              for k, v in rows.items()}
    _, got = unpack_chain(_wire(theirs), ENVELOPE, leaves)
    assert all(np.array_equal(got[k], words[k]) for k in rows)


# ------------------------------------------------------- the envelope

def test_model_signature_is_the_jax_one(tiny):
    jnet, net = tiny
    assert model_signature(net.params, net.state) == \
        jax_model_sig(jnet.params, jnet.state)
    # empty state dicts add nothing, as in the JAX tree
    assert model_signature(net.params, {}) == \
        jax_model_sig(jnet.params, jnet.state)
    jl = jax_lstm()
    assert model_signature(port_of(jl).params, []) == \
        jax_model_sig(jl.params, jl.state)
    other = jax_tiny(n_layers=1)
    assert model_signature(port_of(other).params) != \
        model_signature(net.params)


def test_the_envelope_and_leaf_paths_are_the_jax_engines(tiny):
    jnet, net = tiny
    jeng, eng = JaxDecode(jnet, **_kw()), DecodeEngine(net, **_kw())
    jeng._ensure_dstate()
    eng._ensure_state()
    assert eng._migrate_envelope() == jeng._migrate_envelope()
    mine = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in eng._pool_leaf_items()}
    theirs = {k: (tuple(a.shape), str(a.dtype))
              for k, a in jeng._pool_leaf_items()}
    assert mine == theirs
    assert sorted(mine) == ["['b0_attn']['pk']", "['b0_attn']['pv']",
                            "['b1_attn']['pk']", "['b1_attn']['pv']"]
    # the port's pools are float32 here (serving precision f32), so the
    # engines move float32 rows; bfloat16 rows are held above at the wire
    assert {dt for _, dt in mine.values()} == {"float32"}


# ------------------------------------------------------- engine to engine

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_chain_crosses_between_the_packages(tiny, direction):
    jnet, net = tiny
    prompt = _prompts([20], seed=4)[0]
    jeng, eng = JaxDecode(jnet, **_kw()).start(), _paged(net)
    src, dst = (jeng, eng) if direction == "jax_to_port" else (eng, jeng)
    try:
        ref = src.generate(prompt, max_new_tokens=6)
        payload = _wire(src.kv_export(prompt))
        assert payload["n_blocks"] == 2          # (20 - 1) // 8 claimable
        assert payload["model_sig"] == dst._migrate_envelope()["model_sig"]
        assert sorted(l["path"] for l in payload["leaves"]) == \
            sorted(k for k, _ in dst._pool_leaf_items())
        out = dst.kv_import(payload)
        assert (out["imported_blocks"], out["duplicate_blocks"],
                out["tokens"]) == (2, 0, 16)
        got = dst.generate(prompt, max_new_tokens=6)
        assert got["tokens"] == ref["tokens"]
        st = dst.stats()["kv"]
        assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] == 16
        assert st["migrate_imports"] == 1
    finally:
        jeng.stop()
        eng.stop()


def test_roundtrip_is_bit_for_bit_in_place_and_adds_no_program(tiny):
    _, net = tiny
    src, dst = _paged(net), _paged(net)
    prompt = _prompts([20])[0]
    try:
        ptrs = [t.data_ptr() for _, t in dst._pool_leaf_items()]
        progs = dst.program_stats()
        ref = src.generate(prompt, max_new_tokens=6)
        payload = src.kv_export(prompt)
        assert dst.kv_import(_wire(payload))["imported_blocks"] == 2
        assert dst.generate(prompt, max_new_tokens=6) == ref
        back = dst.kv_export(prompt)
        assert [(l["path"], l["data"]) for l in back["leaves"]] == \
            [(l["path"], l["data"]) for l in payload["leaves"]]
        again = dst.kv_import(_wire(payload))
        assert (again["imported_blocks"], again["duplicate_blocks"]) == (0, 2)
        assert [t.data_ptr() for _, t in dst._pool_leaf_items()] == ptrs
        assert dst.program_stats() == progs and dst.trace_count == 1
        st = dst.stats()["kv"]
        assert (st["migrate_exports"], st["migrate_imports"]) == (1, 2)
        assert st["blocks_in_use"] == 0
    finally:
        src.stop()
        dst.stop()


def test_export_and_import_run_inline_without_a_loop(tiny):
    _, net = tiny
    src, dst = _paged(net), DecodeEngine(net, **_kw())
    prompt = _prompts([20], seed=2)[0]
    try:
        ref = src.generate(prompt, max_new_tokens=4)
        assert dst.kv_import(src.kv_export(prompt))["imported_blocks"] == 2
        assert dst._thread is None               # the state was made for it
        dst.start()
        assert dst.generate(prompt, max_new_tokens=4) == ref
        assert dst.stats()["kv"]["prefix_tokens_saved"] == 16
    finally:
        src.stop()
        dst.stop()
    with pytest.raises(KVMigrateError) as e:
        src.kv_export(_prompts([20], seed=3)[0])
    assert e.value.reason == "no_chain"
    with pytest.raises(ValueError, match="prefix_cache"):
        DecodeEngine(net, **_kw(prefix_cache=False)).kv_export(prompt)


def test_a_mid_chain_copy_on_write_chain_migrates(tiny):
    _, net = tiny
    src, dst = _paged(net), _paged(net)
    p1 = _prompts([20], seed=1)[0]
    p2 = p1[:12] + _prompts([8], seed=2)[0]     # diverges inside block 1
    try:
        r1 = src.generate(p1, max_new_tokens=6)
        r2 = src.generate(p2, max_new_tokens=6)
        assert src.stats()["kv"]["cow_copies"] >= 1
        assert dst.kv_import(src.kv_export(p2))["imported_blocks"] == 2
        assert dst.generate(p2, max_new_tokens=6) == r2
        assert dst.generate(p1, max_new_tokens=6) == r1
    finally:
        src.stop()
        dst.stop()


def test_rejections_leave_the_pool_unchanged_and_are_counted(tiny):
    jnet, net = tiny
    src = _paged(net)
    prompt = _prompts([20])[0]
    try:
        ref = src.generate(prompt, max_new_tokens=4)
        payload = src.kv_export(prompt)
    finally:
        src.stop()
    cases = [(port_of(jax_tiny(n_layers=1)), {}, "model_sig", None),
             (net, {"bs": 16}, "block_size", None),
             (net, {}, "dtype", lambda p: [l.update(dtype="float64")
                                           for l in p["leaves"]]),
             (net, {}, "vocab", lambda p: p.update(vocab=V + 1)),
             (net, {}, "torn", lambda p: p["leaves"][0].update(
                 data=p["leaves"][0]["data"][:100])),
             (net, {}, "torn", _tamper_checksum)]
    for model, kw, reason, tamper in cases:
        dst = _paged(model, **kw)
        try:
            bad = _wire(payload)
            if tamper is not None:
                tamper(bad)
            before = _snapshot(dst)
            n0 = _rejects(dst, reason)
            with pytest.raises(KVMigrateError) as e:
                dst.kv_import(bad)
            assert e.value.reason == reason
            assert _snapshot(dst) == before == (0, dst._pool.usable, 0)
            assert _rejects(dst, reason) == n0 + 1
            if model is net and kw == {}:
                # the destination is unharmed: the good payload lands
                assert dst.kv_import(_wire(payload))["imported_blocks"] == 2
                assert dst.generate(prompt, max_new_tokens=4) == ref
        finally:
            dst.stop()


def test_an_import_the_pool_cannot_hold_is_rejected(tiny):
    _, net = tiny
    src = _paged(net)
    prompt = _prompts([40], seed=6)[0]
    try:
        src.generate(prompt, max_new_tokens=2)
        payload = src.kv_export(prompt)         # 4 blocks
    finally:
        src.stop()
    dst = DecodeEngine(net, **_kw(kv_blocks=4))  # 3 usable
    with pytest.raises(KVMigrateError) as e:
        dst.kv_import(payload)
    assert e.value.reason == "exhausted"
    assert _snapshot(dst) == (0, 3, 0)
