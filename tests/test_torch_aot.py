"""AOT artifacts (exec/aot.py) against the JAX package's, on the CPU.

- ``companion_path`` and ``model_signature`` agree between the packages
  for one configuration; the engines' ``_aot_key`` strings are the JAX
  engines' letter for letter (rungs, masks, dense and paged decode,
  prefill chunks, speculation trees).
- A bundle round-trips and merge-saves; every envelope field's mismatch
  is a miss counted under its reason; a JAX-written artifact is a
  ``format`` miss and the engine traces.
- A restore builds every program from its recipe: ``trace_count == 0``,
  one restore a program, registry records equal the traced engine's, and
  outputs and tokens (greedy and seeded) bit for bit the traced
  engine's. A recipe its program does not reproduce is a ``corrupt`` miss
  and the engine traces (the stale-signature fallback), as does a rung
  the artifact never saw.
- Rotation unlinks a checkpoint's companion in both packages and
  ``latest_aot`` agrees.
- ``ops.build.install_libraries`` installs a member only under a current
  digest name and after its sha256 matched (fake library files here).
- On the card (``cuda``, skipped here): a restore captures one graph a
  program whose launches equal the recipe's. The JAX package is imported
  inside the tests that compare with it, so this file also runs where
  only the port is installed.
"""

import hashlib
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.exec import aot
from deeplearning4j_tpu_torch.exec.programs import get_programs
from deeplearning4j_tpu_torch.monitor import get_registry
from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.resilience import checkpoint as ckpt
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
from deeplearning4j_tpu_torch.serving.spec import SpecConfig

V, MAXLEN = 13, 64            # test_torch_kv_prefix's models
PROMPT = [1, 2, 3, 4, 5, 6, 7]
FIELDS = ("flops", "bytes", "kernel_flops", "kernel_bytes", "launches")


def _jax():
    """The JAX package's modules the comparisons read."""
    from deeplearning4j_tpu.exec import aot as jaot
    from deeplearning4j_tpu.resilience import checkpoint as jckpt
    return jaot, jckpt


@pytest.fixture(scope="module")
def nets():
    import test_torch_kv_prefix as kvp
    from test_torch_kv_prefix import jax_lstm, jax_transformer
    from test_torch_regularised_training import port_of
    assert (kvp.V, kvp.MAXLEN) == (V, MAXLEN)
    jt, jl = jax_transformer(), jax_lstm()
    draft = jax_transformer(seed=3, n_layers=1)
    return {"tiny": (jt, port_of(jt)), "lstm": (jl, port_of(jl)),
            "draft": (draft, port_of(draft))}


def _x(n=3, t=6, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (n, t))]


def _misses(reason):
    fam = get_registry().get("dl4jtpu_aot_misses_total")
    if fam is None:
        return 0.0
    return sum(c.value for key, c in fam.children() if key == (reason,))


def test_companion_path_and_signature_match_jax(nets):
    jaot, _ = _jax()
    for p in ("/a/model.zip", "ckpt", "x/checkpoint_iter0000000012.zip"):
        assert aot.companion_path(p) == jaot.companion_path(p)
    for name in ("tiny", "lstm"):
        jnet, net = nets[name]
        assert aot.model_signature(net.params, net.state) == \
            jaot.model_signature(jnet.params, jnet.state)
    # another width is another signature
    assert aot.model_signature(nets["tiny"][1].params) != \
        aot.model_signature(nets["draft"][1].params)


def test_engine_keys_match_jax(nets):
    from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
    for name, shapes, mask in (("tiny", [(6, V)], None),
                               ("lstm", [(9, V)], None),
                               ("lstm", [(9, V)], 9)):
        jnet, net = nets[name]
        ours, theirs = InferenceEngine(net, 16), JaxEngine(jnet, 16)
        for b in (1, 2, 8, 16):
            for dt in (np.float32, np.float16):
                assert ours._aot_key(b, shapes, dt, mask) == \
                    theirs._aot_key(b, shapes, dt, mask)


@pytest.mark.parametrize("kind", ["dense", "paged", "chunked", "spec"])
def test_decode_keys_match_jax(nets, kind):
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
    from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpec
    jnet, net = nets["tiny"]
    kw = {"dense": {}, "paged": dict(kv="paged", kv_block_size=8),
          "chunked": dict(kv="paged", kv_block_size=8, chunk_tokens=4,
                          kv_blocks=13),
          "spec": {}}[kind]
    if kind == "spec":
        ours = DecodeEngine(net, 2, MAXLEN, spec=SpecConfig(
            nets["draft"][1], tree=(3, 2)), **kw)
        theirs = JaxDecode(jnet, 2, MAXLEN, spec=JaxSpec(
            nets["draft"][0], tree=(3, 2)), **kw)
    else:
        ours = DecodeEngine(net, 2, MAXLEN, **kw)
        theirs = JaxDecode(jnet, 2, MAXLEN, **kw)
    kinds = ["step"] + (["prefill"] if "chunk_tokens" in kw else []) \
        + (["cow"] if kind != "dense" and kind != "spec" else []) \
        + (["draft", "verify"] if kind == "spec" else [])
    for k in kinds:
        assert ours._aot_key(k) == theirs._aot_key(k), k
    ours._build_programs()
    assert sorted(ours._programs) == sorted(kinds)


def test_bundle_round_trip_and_merge_save(tmp_path):
    path = str(tmp_path / "m.aot.zip")
    env = aot.env_fingerprint("cpu")
    a = aot.AotBundle("sig", "f32", env=env)
    rec = {"flops": 1.0, "bytes": 2.0, "kernel_flops": 0.5,
           "kernel_bytes": 0.25, "launches": {"flash_attn_fwd": 2},
           "memory_bytes": None, "compile_seconds": 9.0}
    a.add_recipe("k1", rec, "int32[4]")
    lib = {"name": "x.so", "stem": "x", "sha256": "00",
           "nvcc": "Build cuda_12", "data": b"\x7fELF"}
    a.add_libraries([lib])
    a.save(path)
    b = aot.AotBundle("sig", "f32", env=env)
    b.add_recipe("k2", dict(rec, flops=3.0), "int32[8]")
    b.save(path)                                  # merges with a's
    got = aot.AotBundle.load(path)
    assert got.keys() == {"k1", "k2"} and len(got) == 2
    r1 = got.recipe("k1")
    assert r1 == {"flops": 1.0, "bytes": 2.0, "kernel_flops": 0.5,
                  "kernel_bytes": 0.25, "launches": {"flash_attn_fwd": 2},
                  "memory_bytes": None, "layout": "int32[4]"}
    assert got.recipe("k2")["flops"] == 3.0
    assert got.libraries == [lib] and got.nvcc == "Build cuda_12"
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["kernels/x.so", "meta.json",
                                        "programs/0000.json",
                                        "programs/0001.json"]
    # an incompatible bundle replaces the file instead of merging
    c = aot.AotBundle("other", "f32", env=env)
    c.add_recipe("k3", rec, "int32[1]")
    c.save(path)
    assert aot.AotBundle.load(path).keys() == {"k3"}
    before = _misses("key")
    assert got.recipe("nope") is None and _misses("key") == before + 1


@pytest.mark.parametrize("reason", ["no_artifact", "corrupt", "format",
                                    "backend", "torch", "arch", "model_sig",
                                    "precision"])
def test_each_envelope_mismatch_is_a_counted_miss(tmp_path, reason):
    jaot, _ = _jax()
    path = str(tmp_path / "m.aot.zip")
    env = aot.env_fingerprint("cpu")
    sig, prec = "sig", "f32"
    if reason == "corrupt":
        open(path, "wb").write(b"not a zip")
    elif reason == "format":
        jaot.AotBundle(sig, prec, env={"backend": "cpu", "jaxlib": "0",
                                       "jax": "0"}).save(path)
    elif reason != "no_artifact":
        bad = dict(env)
        if reason in bad:
            bad[reason] = "elsewhere"
        aot.AotBundle("other" if reason == "model_sig" else sig,
                      "int8" if reason == "precision" else prec,
                      env=bad).save(path)
    before = _misses(reason)
    bundle, why = aot.open_bundle(path, sig, prec, "cpu")
    assert bundle is None and why == reason
    assert _misses(reason) == before + 1
    assert reason in aot.MISS_REASONS


def test_jax_artifact_is_a_format_miss_and_the_engine_traces(nets,
                                                             tmp_path):
    jaot, _ = _jax()
    jnet, net = nets["tiny"]
    path = str(tmp_path / "jax.aot.zip")
    jaot.AotBundle(jaot.model_signature(jnet.params, jnet.state), "f32",
                   env={"backend": "cpu", "jaxlib": "0", "jax": "0"}
                   ).save(path)
    before = _misses("format")
    eng = InferenceEngine(net, 4)
    eng.warmup((6, V), aot=path)
    assert _misses("format") == before + 1
    assert (eng.trace_count, eng.aot_restores) == (3, 0)
    # the port's recipes replaced the foreign artifact
    assert aot.AotBundle.load(path).keys() == {
        eng._aot_key(b, [(6, V)], np.float32) for b in (1, 2, 4)}


def _records(caller, keys):
    return {k: {f: get_programs().get(caller, k)[f] for f in FIELDS}
            for k in keys}


def test_bucketed_restore_is_bitwise_with_no_trace(nets, tmp_path):
    jnet, lstm = nets["lstm"]
    path = str(tmp_path / "lstm.aot.zip")
    traced = InferenceEngine(lstm, 8)
    traced.predict_host(_x(3, 9))           # rung 4 met before the warmup
    traced.warmup((9, V), with_mask_len=9, aot=path)
    restored = InferenceEngine(lstm, 8)
    restored.warmup((9, V), with_mask_len=9, aot=path)
    keys = [f"b{b}{m}" for b in (1, 2, 4, 8) for m in ("", "_mask")]
    assert (traced.trace_count, restored.trace_count,
            restored.aot_restores) == (8, 0, 8)
    assert sorted(restored._aot) == sorted(
        (b, m) for b in (1, 2, 4, 8) for m in (False, True))
    assert _records(traced.id, keys) == _records(restored.id, keys)
    for n in (1, 3, 8):
        x = _x(n, 9, seed=n)
        m = np.ones((n, 9), np.float32)
        m[:, 7:] = 0
        assert np.array_equal(traced.predict_host(x),
                              restored.predict_host(x))
        assert np.array_equal(traced.predict_host(x, m),
                              restored.predict_host(x, m))
    assert restored.trace_count == 0


def _serve(eng, prompts):
    eng.start()
    try:
        return ([eng.generate(p, 8) for p in prompts]
                + [eng.generate(p, 8, seed=5, temperature=0.9, top_k=4)
                   for p in prompts])
    finally:
        eng.stop()


@pytest.mark.parametrize("kind", ["dense", "paged", "spec"])
def test_decode_restore_is_bitwise_with_no_trace(nets, tmp_path, kind):
    _, net = nets["tiny"]
    path = str(tmp_path / f"{kind}.aot.zip")
    kw = {"dense": {}, "paged": dict(kv="paged", kv_block_size=8,
                                     chunk_tokens=4),
          "spec": dict(spec=SpecConfig(nets["draft"][1], tree=(2, 2)))}[kind]
    prompts = [PROMPT, PROMPT[:3] + [9, 9, 9, 9, 9, 9, 9, 9, 1]]
    traced = DecodeEngine(net, 2, MAXLEN, **kw)
    traced.warmup(aot=path)
    restored = DecodeEngine(net, 2, MAXLEN, **kw)
    restored.warmup(aot=path)
    n = len(restored._programs)
    assert (traced.trace_count, traced.aot_restores) == (1, 0)
    assert (restored.trace_count, restored.aot_restores) == (0, n)
    assert _records(traced.id, restored._programs) == \
        _records(restored.id, restored._programs)
    assert _serve(traced, prompts) == _serve(restored, prompts)
    assert restored.trace_count == 0


def test_stale_recipes_fall_back_to_tracing(nets, tmp_path):
    jnet, lstm = nets["lstm"]
    path = str(tmp_path / "lstm.aot.zip")
    InferenceEngine(lstm, 4).warmup((9, V), with_mask_len=9, aot=path)
    # a sequence and mask length the artifact never saw: key misses,
    # traced and saved beside the others
    before = _misses("key")
    eng = InferenceEngine(lstm, 4)
    eng.warmup((7, V), with_mask_len=7, aot=path)
    assert (eng.trace_count, eng.aot_restores) == (6, 0)
    assert _misses("key") == before + 6
    assert len(aot.AotBundle.load(path)) == 12
    # recipes whose launches or layout the programs do not reproduce
    b = aot.AotBundle.load(path)
    for k in b.keys():
        b._programs[k]["launches"] = {"lstm_fwd": 99}
    os.unlink(path)
    b.save(path)
    before = _misses("corrupt")
    eng = InferenceEngine(lstm, 4)
    eng.warmup((9, V), aot=path)
    assert (eng.trace_count, eng.aot_restores) == (3, 0)
    assert _misses("corrupt") == before + 3
    x = _x(3, 9)
    assert np.array_equal(eng.predict_host(x),
                          InferenceEngine(lstm, 4).predict_host(x))
    # a decode program's bad recipe drops the engine back wholesale
    _, tiny = nets["tiny"]
    dpath = str(tmp_path / "paged.aot.zip")
    kw = dict(kv="paged", kv_block_size=8, chunk_tokens=4)
    DecodeEngine(tiny, 2, MAXLEN, **kw).warmup(aot=dpath)
    b = aot.AotBundle.load(dpath)
    key = next(k for k in b.keys() if k.startswith("decode:cow"))
    b._programs[key]["layout"] = "int32[3]"
    os.unlink(dpath)
    b.save(dpath)
    eng = DecodeEngine(tiny, 2, MAXLEN, **kw)
    eng.warmup(aot=dpath)
    assert (eng.trace_count, eng.aot_restores) == (1, 0)
    assert _serve(eng, [PROMPT]) == _serve(
        DecodeEngine(tiny, 2, MAXLEN, **kw), [PROMPT])


def test_rotation_unlinks_the_companion_in_both_packages(nets, tmp_path):
    _, jckpt = _jax()
    jnet, net = nets["lstm"]
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jm = jckpt.CheckpointManager(jd, keep_last=2)
    pm = ckpt.CheckpointManager(pd, keep_last=2)
    for it in (1, 2, 3):
        for n, m in ((jnet, jm), (net, pm)):
            n.iteration, n.epoch = it, 0
            path = m.save(n)
            open(aot.companion_path(path), "wb").close()
    assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
    assert not any("iter0000000001" in f for f in os.listdir(pd))
    assert sum(f.endswith(".aot.zip") for f in os.listdir(pd)) == 2
    assert os.path.basename(pm.latest_aot()) == \
        os.path.basename(jm.latest_aot())
    os.unlink(pm.latest_aot())
    assert pm.latest_aot() is None


def test_install_libraries_checks_digest_and_name(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    names = sorted(build.current_names())
    good = b"\x7fELF fake library"
    sha = hashlib.sha256(good).hexdigest()
    members = [
        {"name": names[0], "stem": "a", "sha256": sha, "data": good},
        {"name": names[1], "stem": "b", "sha256": sha, "data": b"torn"},
        {"name": "lstm_fwd-0000000000000000.so", "stem": "lstm_fwd",
         "sha256": sha, "data": good},
        {"name": "../" + names[2], "stem": "c", "sha256": sha,
         "data": good}]
    before = (_misses("corrupt"), _misses("key"))
    report = build.install_libraries(members)
    assert report["installed"] == [names[0]]
    assert [r for _, r in report["refused"]] == ["corrupt", "key", "key"]
    assert (_misses("corrupt"), _misses("key")) == \
        (before[0] + 1, before[1] + 2)
    assert sorted(os.listdir(tmp_path / "build")) == [names[0]]
    assert (tmp_path / "build" / names[0]).read_bytes() == good
    # installed libraries export back under their names and digests
    monkeypatch.setattr(build, "nvcc_version", lambda: "Build cuda_x")
    out = build.export_libraries()
    assert [(m["name"], m["sha256"], m["nvcc"]) for m in out] == \
        [(names[0], sha, "Build cuda_x")]
    assert build.install_libraries(members[:1])["present"] == [names[0]]


def test_concurrent_installs_and_saves_are_atomic(tmp_path, monkeypatch):
    """Writers racing on one name (replicas starting together on an empty
    build directory, engines saving one artifact) leave a whole file and
    no temporary one."""
    import threading
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    name = sorted(build.current_names())[0]
    data = os.urandom(1 << 20)
    member = {"name": name, "stem": "x", "data": data,
              "sha256": hashlib.sha256(data).hexdigest()}
    art = str(tmp_path / "m.aot.zip")
    env = aot.env_fingerprint("cpu")
    rec = {"flops": 1.0, "bytes": 1.0, "kernel_flops": 0.0,
           "kernel_bytes": 0.0, "launches": {}, "memory_bytes": None}

    def work(i):
        build.install_libraries([member])
        b = aot.AotBundle("sig", "f32", env=env)
        b.add_recipe(f"k{i}", rec, "int32[1]")
        b.save(art)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert os.listdir(tmp_path / "build") == [name]
    assert (tmp_path / "build" / name).read_bytes() == data
    assert sorted(os.listdir(tmp_path)) == ["build", "m.aot.zip"]
    got = aot.AotBundle.load(art)         # whole; merges may interleave
    assert got.keys() and got.keys() <= {f"k{i}" for i in range(8)}


@pytest.mark.cuda
def test_restore_on_the_card_captures_each_program_once(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    net = TinyTransformer(vocab_size=V, d_model=32, n_heads=4,
                          max_len=MAXLEN).init(device="cuda")
    path = str(tmp_path / "card.aot.zip")
    kw = dict(kv="paged", kv_block_size=8, chunk_tokens=4)
    traced = DecodeEngine(net, 2, MAXLEN, **kw)
    traced.warmup(aot=path)
    t_eng = InferenceEngine(net, 4)
    t_eng.warmup((6, V), aot=path)
    assert aot.AotBundle.load(path).libraries
    restored = DecodeEngine(net, 2, MAXLEN, **kw)
    restored.warmup(aot=path)
    r_eng = InferenceEngine(net, 4)
    r_eng.warmup((6, V), aot=path)
    assert (restored.trace_count, r_eng.trace_count) == (0, 0)
    stats = restored.program_stats()
    for kind, st in stats.items():
        assert (st["programs"], st["captures"]) == (1, 1), kind
        rec = get_programs().get(restored.id, kind)
        assert st["launches"] == [rec["launches"]]
        assert rec["launches"] == get_programs().get(traced.id,
                                                     kind)["launches"]
    assert r_eng.captures == 3
    assert _serve(traced, [PROMPT]) == _serve(restored, [PROMPT])
