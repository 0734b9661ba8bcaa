"""The host KV tier and KV-chain migration on the card, at a small size:
the bars of ``chip_smoke.py`` phase 14 (a) and (b) without the rest of the
smoke. No JAX: this file runs where the port runs.

- Waves of prompts on a captured paged engine whose pool holds one wave:
  the second evicts (spills) the first's cached blocks, the third (the
  first's prompts again) restores them. Tokens equal, bit for bit, those
  of the same engine without a tier, which prefills the third wave again.
- K9 exactly twice a plain step (the spills and restores launch none), no
  capture after ``warmup()``, ``trace_count`` 1, the prefill and
  copy-on-write programs unchanged, every pool leaf at its address, no
  block in use at the end.
- A chain exported from one captured engine and imported into another
  continues bit for bit there, written in place, with no new capture.

Every test skips without a card: a CUDA kernel has no CPU mode.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, MAXLEN, BS, NEW = 13, 64, 8, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _net(device):
    return TinyTransformer(vocab_size=V, n_layers=2, d_model=32, n_heads=4,
                           max_len=MAXLEN, seed=7).init(device=device)


def _waves():
    """Three waves of 2 prompts of 24 tokens (3 full blocks each): A, B,
    A again. Each prompt has its own first token, so no prompt claims
    another's block by copy-on-write."""
    rng = np.random.default_rng(5)
    ps = [[i] + list(map(int, rng.integers(0, V, size=23)))
          for i in range(4)]
    return [ps[:2], ps[2:], ps[:2]]


def _kw(**kw):
    # 2 streams of 24 + 8 positions: 4 blocks each, the pool 8 usable
    return dict(dict(slots=2, max_len=MAXLEN, kv="paged", kv_block_size=BS,
                     chunk_tokens=8, kv_blocks=9), **kw)


def _serve(eng, waves):
    out, steps = [], []
    for wave in waves:
        st0 = eng.stats()["steps"]
        futs = [eng.submit(p, max_new_tokens=NEW) for p in wave]
        out.append([f.result(timeout=300)["tokens"] for f in futs])
        steps.append(eng.stats()["steps"] - st0)
    return out, steps


def _leaves(eng):
    return [t.data_ptr() for _, t in eng._pool_leaf_items()]


@pytest.mark.cuda
def test_spill_and_restore_on_the_card(cuda_device):
    net = _net(cuda_device)
    waves = _waves()
    plain = DecodeEngine(net, **_kw()).start()
    try:
        want, _ = _serve(plain, waves)
        assert plain.stats()["kv"]["prefix_hits"] == 0
    finally:
        plain.stop()
    eng = DecodeEngine(net, **_kw(host_kv_bytes=1 << 20)).start()
    try:
        ptrs, progs = _leaves(eng), eng.program_stats()
        ops.reset_launch_counts()
        got, steps = _serve(eng, waves)
        launches = ops.launch_counts()
        st = eng.stats()
    finally:
        eng.stop()
    assert got == want
    tier = st["kv"]["host_tier"]
    # A's 6 published blocks spill in B, B's 6 in the third wave, which
    # restores the 2 claimable blocks ((24 - 1) // 8) of each prompt
    assert tier["spills"] == 12 and st["kv"]["host_restores"] == 4
    assert (st["kv"]["prefix_hits"], st["kv"]["prefix_tokens_saved"]) == \
        (2, 32)
    assert launches == {"flash_decode_paged": 2 * sum(steps)}
    assert _leaves(eng) == ptrs and eng.program_stats() == progs
    assert eng.trace_count == 1 and st["kv"]["blocks_in_use"] == 0
    assert all(p["captures"] == 1 for p in progs.values())


@pytest.mark.cuda
def test_a_migrated_chain_continues_on_the_card(cuda_device):
    net = _net(cuda_device)
    prompt = _waves()[0][0]
    src = DecodeEngine(net, **_kw()).start()
    dst = DecodeEngine(net, **_kw()).start()
    try:
        ref = src.generate(prompt, max_new_tokens=NEW)
        payload = json.loads(json.dumps(src.kv_export(prompt)))
        ptrs, progs = _leaves(dst), dst.program_stats()
        ops.reset_launch_counts()
        out = dst.kv_import(payload)
        assert ops.launch_counts() == {}
        assert (out["imported_blocks"], out["duplicate_blocks"]) == (3, 0)
        assert dst.generate(prompt, max_new_tokens=NEW) == ref
        back = dst.kv_export(prompt)
        assert [l["data"] for l in back["leaves"]] == \
            [l["data"] for l in payload["leaves"]]
        assert _leaves(dst) == ptrs and dst.program_stats() == progs
        # 2 blocks claimed, the third by copy-on-write up to the last token
        assert dst.stats()["kv"]["prefix_tokens_saved"] == 23
    finally:
        src.stop()
        dst.stop()
