"""The decode engine's captured programs on the card, against the same
engine run eagerly (the ``_capture_programs = False`` seam). No JAX: this
file runs where the port runs.

For every program -- the plain step (dense and paged), the prefill chunk,
the copy-on-write, the draft and the verify:

- captured equals eager bit for bit: the tokens, and every leaf of the
  decode state, the draft's stacks and its proposals (``torch.equal``);
- one replay launches what one eager call launches (the kernel counts of
  the whole run are equal, and each graph's recorded launches are the
  step's K8 or K9 once an attention layer, the draft's K8 once a layer and
  position, none for a chunk or a copy);
- a resident tensor passed at another address raises;
- ``start()`` captures every program on the caller's thread, and the
  loop thread captures nothing afterwards;
- each program is registered with one replay's launches and the hand
  kernels' work reckoned from its shapes, and reading the registry
  captures nothing.

Every test skips without a card: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn.layers.base import map_tree
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, MAXLEN = 13, 64
CASES = {
    "dense": lambda d: {},
    "paged-prefix-chunk": lambda d: dict(kv="paged", kv_block_size=16,
                                         chunk_tokens=8),
    "spec-dense": lambda d: dict(spec=SpecConfig(d, tree=(3, 2, 2))),
    "spec-paged-chunk": lambda d: dict(kv="paged", kv_block_size=16,
                                       chunk_tokens=8,
                                       spec=SpecConfig(d, k=4)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _nets(device):
    net = TinyTransformer(vocab_size=V, n_layers=2, d_model=32, n_heads=4,
                          max_len=MAXLEN, seed=7).init(device=device)
    draft = TinyTransformer(vocab_size=V, n_layers=1, d_model=16, n_heads=2,
                            max_len=MAXLEN, seed=3).init(device=device)
    return net, draft


def _prompts():
    rng = np.random.default_rng(11)
    stem = list(map(int, rng.integers(0, V, size=36)))
    return [stem + [1, 2, 3], stem[:20] + [4, 5], stem[:33] + [6], [2, 7]]


def _run(eng, prompts):
    eng.start()
    try:
        ops.reset_launch_counts()
        futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        toks = [f.result(timeout=300)["tokens"] for f in futs]
        toks += [eng.generate(p, max_new_tokens=6, seed=5, temperature=0.8,
                              timeout=300)["tokens"] for p in prompts[:2]]
        return toks, ops.launch_counts()
    finally:
        eng.stop()


def _state(eng):
    out = [eng._dstate]
    if eng._draft is not None:
        out += [eng._draft._tree, eng._draft.props, eng._draft.sides]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_equals_eager_bit_for_bit(cuda_device, case):
    net, draft = _nets(cuda_device)
    engines = []
    for capture in (False, True):
        eng = DecodeEngine(net, slots=3, max_len=MAXLEN,
                           **CASES[case](draft))
        eng._capture_programs = capture
        engines.append((eng, _run(eng, _prompts())))
    (eager, (etoks, elaunch)), (capt, (ctoks, claunch)) = engines
    assert ctoks == etoks
    assert claunch == elaunch and claunch
    map_tree(lambda a, b: torch.equal(a, b) or pytest.fail(
        "captured state differs from eager"), _state(capt), _state(eager))
    progs = capt.program_stats()
    assert all(p["captures"] == 1 for p in progs.values())
    assert not any(p["captures"] for p in eager.program_stats().values())
    kernel = "flash_decode_paged" if capt.kv == "paged" else "flash_decode"
    assert progs["step"]["launches"] == [{kernel: 2}]
    for k in ("prefill", "cow"):
        if k in progs:
            assert progs[k]["launches"] == [{}]
    if "draft" in progs:
        assert progs["draft"]["launches"] == [{"flash_decode":
                                               capt._draft.k}]
        assert progs["verify"]["launches"] == [{"flash_decode": 2}]


@pytest.mark.cuda
def test_a_resident_tensor_at_another_address_raises(cuda_device):
    net, draft = _nets(cuda_device)
    eng = DecodeEngine(net, slots=2, max_len=MAXLEN,
                       spec=SpecConfig(draft, k=2))
    eng.warmup()
    stage = eng._stages["step"]
    stage.open()
    moved = map_tree(lambda t: t.clone(), eng._dstate)
    with pytest.raises(ValueError, match="resident"):
        eng._programs["step"]({"params": eng._params, "state": moved},
                              stage.tensor)
    with pytest.raises(ValueError, match="resident"):
        eng._programs["draft"](dict(eng._draft.resident(),
                                    props=eng._draft.props.clone()),
                               eng._draft._stage.tensor)


@pytest.mark.cuda
def test_start_leaves_no_capture_for_the_loop_thread(cuda_device):
    net, draft = _nets(cuda_device)
    eng = DecodeEngine(net, slots=3, max_len=MAXLEN, kv="paged",
                       kv_block_size=16, chunk_tokens=8,
                       spec=SpecConfig(draft, tree=(3, 2)))
    eng.start()
    try:
        after_start = eng.program_stats()
        assert set(after_start) == {"step", "prefill", "cow", "draft",
                                    "verify"}
        assert all(p["captures"] == 1 for p in after_start.values())
        assert all(p.sealed for p in eng._programs.values())
        for p in _prompts():
            eng.generate(p, max_new_tokens=8, timeout=300)
        assert eng.program_stats() == after_start
        assert eng.trace_count == 1
    finally:
        eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_registered_programs_carry_the_kernels_work(cuda_device, kv):
    """Each captured program is registered (exec/programs.py) with the
    launches one replay adds and the hand kernels' work reckoned from the
    program's shapes: for the step, once an attention layer, 4 Dh H
    operations per cache row of every slot's whole capacity, the rows of
    K and V at the cache's width, q and the output in float32 (K9: and
    the page-table entries). Reading the registry captures nothing."""
    from deeplearning4j_tpu_torch.exec import get_programs
    net, _ = _nets(cuda_device)
    kw = {} if kv == "dense" else dict(kv="paged", kv_block_size=16)
    eng = DecodeEngine(net, slots=2, max_len=MAXLEN, **kw)
    eng.start()
    try:
        stats = eng.program_stats()
        rec = get_programs().get(eng.id, "step")
        assert eng.program_stats() == stats
        (graph,) = eng._programs["step"].graphs.values()
        assert rec["launches"] == graph.launches
        ops.reset_launch_counts()
        s0 = eng._steps
        for _ in range(3):
            eng.generate([1, 2, 3], max_new_tokens=4, timeout=300)
        per_step = {k: n / (eng._steps - s0)
                    for k, n in ops.launch_counts().items()}
        assert per_step == rec["launches"]
        S, H, Dh, L = 2, 4, 8, 2
        if kv == "dense":
            rows, entries = S * MAXLEN, 0
        else:
            MB = eng._max_blocks
            rows, entries = S * MB * 16, S * MB
        flops = 4.0 * Dh * H * rows
        nbytes = 4 * (2 * S * H * Dh + S) + 4 * 2 * rows * H * Dh \
            + 4 * entries
        assert rec["kernel_flops"] == L * flops
        assert rec["kernel_bytes"] == L * nbytes
        assert rec["flops"] > rec["kernel_flops"]
        assert rec["memory_bytes"] is not None and rec["memory_bytes"] > 0
        assert rec["compile_seconds"] > 0
    finally:
        eng.stop()
