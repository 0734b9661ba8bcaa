"""The kernel paths of the prefix cache, chunked prefill and speculation
on the card, against the CPU port. No JAX: this file runs where the port
runs.

- A verify's ``tree_chunk`` runs K8 (``flash_decode``) once an attention
  layer over every node's effective cache, dense and paged, within 1e-4
  of the plain version (the same layer on the CPU).
- A paged engine with the prefix cache and chunked prefill writes the
  same pool contents (chunks and copy-on-write) as the CPU port, within
  1e-4, with the same tokens and counters.

Every test skips without a card: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.spec import TreeSpec
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, MAXLEN, TOL = 13, 64, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _layer_state(kv, device, B, C, bs, tables, seed=0):
    layer = MultiHeadAttention(n_in=32, n_out=32, n_heads=4, causal=True)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.to(device) for k, v in layer.init(gen).items()}
    if kv == "paged":
        NB = int(tables.max()) + 1
        return layer, params, layer.init_paged_decode_state(
            params, B, C, NB, bs, device=device)
    return layer, params, layer.init_decode_state(params, B, C,
                                                  device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_verify_tree_chunk_runs_k8_and_matches_plain(cuda_device, kv):
    B, C, bs = 3, 64, 16
    tr = TreeSpec((3, 2, 2))
    r = np.random.RandomState(1)
    tables = (r.permutation(B * C // bs) + 1).reshape(B, C // bs) \
        .astype(np.int32)
    pos0 = np.array([9, 30, 50], np.int32)
    x = r.randn(B, 50, 32).astype(np.float32)
    xn = r.randn(B, tr.n_nodes, 32).astype(np.float32)
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        layer, params, d = _layer_state(kv, dev, B, C, bs, tables)
        kw = ({} if kv == "dense" else
              {"block_tables": torch.tensor(tables, device=dev)})
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        layer.prefill_chunk(params, d, torch.tensor(x, device=dev), z,
                            torch.tensor(pos0, device=dev), **kw)
        ops.reset_launch_counts()
        y, _, _, win = layer.tree_chunk(
            params, d, torch.tensor(xn, device=dev),
            torch.tensor(pos0, device=dev), tr,
            torch.full((B,), tr.d + 1, device=dev), **kw)
        outs[dev.type] = (y.cpu(), win["k"].cpu(), ops.launch_counts())
    assert outs["cpu"][2] == {}
    assert outs["cuda"][2] == {"flash_decode": 1}
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_prefill_and_cow_writes_on_the_card_match_the_cpu_port(cuda_device):
    net = TinyTransformer(vocab_size=V, n_layers=2, d_model=32, n_heads=4,
                          max_len=MAXLEN, seed=7).init(device=cuda_device)
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    rng = np.random.default_rng(11)
    stem = list(map(int, rng.integers(0, V, size=36)))
    prompts = [stem + [1, 2, 3], stem[:20] + [4, 5], stem[:33] + [6],
               list(stem)]
    kw = dict(slots=4, max_len=MAXLEN, kv="paged", kv_block_size=16,
              chunk_tokens=8)
    engines = (DecodeEngine(net, **kw), DecodeEngine(cpu, **kw))
    runs = []
    for eng in engines:
        eng.start()
        try:
            runs.append(([eng.generate(p, max_new_tokens=6,
                                       timeout=120)["tokens"]
                          for p in prompts], eng.stats()["kv"]))
        finally:
            eng.stop()
    (got, kv), (want, ckv) = runs
    assert got == want and kv == ckv
    assert kv["cow_copies"] > 0 and kv["prefill_chunks"] > 0
    card, host = (e._dstate for e in engines)
    for name, d in card.items():
        if d is not None:
            for key in ("pk", "pv"):
                np.testing.assert_allclose(d[key][1:].cpu().numpy(),
                                           host[name][key][1:].numpy(),
                                           rtol=0, atol=TOL)
