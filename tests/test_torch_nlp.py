"""The port's nlp package (word2vec family, GloVe, ParagraphVectors, the
distributed trainer, serializer, CNN sentence iterator, segmenters) held
against the JAX package on the CPU.

- Host draws: vocabularies, Huffman codes, unigram tables, subsampled
  corpora, pairs, CBOW windows and initial tables are bitwise equal.
- One step of every update, fed the same tables and, for the NEG steps,
  the indices ``jax.random.randint`` draws for the JAX step's key: rtol
  1e-5, atol 1e-6 (float32; scatter-adds may sum in another order).
- End to end where nothing is drawn on the device: skip-gram HS and CBOW
  HS within atol 2e-5 of the JAX tables (largest seen 4.7e-6 on tables of
  scale 1.2), GloVe within atol 2e-6 (seen 2.4e-7).
- End to end on the NEG paths (skip-gram with shared and per-pair
  negatives, CBOW, ``DistributedWord2Vec`` on a 1- and a 4-slot mesh,
  PV-DBOW and PV-DM with ``infer_vector``): the port's draw functions
  replay the indices JAX's key stream draws (``_JaxDraws``), and the
  tables agree within the one-step tolerance (largest seen 1.6e-7).
  Without the replay the port draws from a ``torch.Generator``, held to
  the JAX suite's cluster checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
from deeplearning4j_tpu.nlp import word2vec as jw
from deeplearning4j_tpu.nlp import glove as jg
from deeplearning4j_tpu.nlp import segmenters as jseg
from deeplearning4j_tpu.nlp.vocab import build_huffman as j_huffman
from deeplearning4j_tpu.nlp.vocab import unigram_table as j_unigram

import deeplearning4j_tpu_torch.nlp as P
from deeplearning4j_tpu_torch.exec.mesh import Mesh, Slot
from deeplearning4j_tpu_torch.nlp import distributed_word2vec as pdw
from deeplearning4j_tpu_torch.nlp import glove as pg
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as ppv
from deeplearning4j_tpu_torch.nlp import segmenters as pseg
from deeplearning4j_tpu_torch.nlp import word2vec as pw
from deeplearning4j_tpu_torch.nlp.vocab import build_huffman as p_huffman
from deeplearning4j_tpu_torch.nlp.vocab import unigram_table as p_unigram

STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
HS_ATOL = 2e-5
GLOVE_ATOL = 2e-6


def _corpus(n_reps=60):
    """The JAX suite's corpus: two clear topic clusters."""
    a = ["the cat sat on the mat with another cat",
         "a cat and a kitten play with the mat",
         "the kitten chased the cat around the mat"]
    b = ["stocks rose as the market rallied today",
         "the market fell while stocks dropped today",
         "investors sold stocks as the market crashed"]
    return (a + b) * n_reps


def _pair(cls_name="Word2Vec", **kw):
    """The same model in both packages (the port's on the CPU)."""
    return (getattr(J, cls_name)(**kw),
            getattr(P, cls_name)(device="cpu", **kw))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------- host draws

@pytest.mark.parametrize("hs", [False, True])
def test_vocab_huffman_unigram_and_tables_are_bitwise(hs):
    kw = dict(min_word_frequency=3, layer_size=16, window_size=3, seed=7,
              sentences=_corpus(4), subsampling=1e-2,
              use_hierarchic_softmax=hs)
    j, p = _pair(**kw)
    j.build_vocab()
    p.build_vocab()
    jw_, pw_ = j.vocab.vocab_words(), p.vocab.vocab_words()
    assert [(w.word, w.count, w.index, w.codes, w.points) for w in jw_] == \
        [(w.word, w.count, w.index, w.codes, w.points) for w in pw_]
    assert j.vocab.total_word_count == p.vocab.total_word_count
    j._init_tables()
    p._init_tables()
    np.testing.assert_array_equal(np.asarray(j.syn0), p.syn0.numpy())
    np.testing.assert_array_equal(np.asarray(j.syn1), p.syn1.numpy())
    np.testing.assert_array_equal(np.asarray(j._table), p._table.numpy())
    np.testing.assert_array_equal(j_unigram(j.vocab), p_unigram(p.vocab))
    for a, b in zip(j._encode_flat(), p._encode_flat()):
        np.testing.assert_array_equal(a, b)
    js, ps = j._encode_corpus(), p._encode_corpus()
    assert len(js) == len(ps)
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j._make_pairs(js, np.random.RandomState(3)),
                    p._make_pairs(ps, np.random.RandomState(3))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j._make_cbow_windows(js, np.random.RandomState(4), True),
                    p._make_cbow_windows(ps, np.random.RandomState(4), True)):
        np.testing.assert_array_equal(a, b)
    if hs:
        for a, b in zip(j._huffman_tables(), p._huffman_tables()):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_neg_pairs_are_the_jax_fit_pairs():
    """The NEG fit's staged pairs: JAX's packed int32 words."""
    j, p = _pair(min_word_frequency=3, layer_size=8, window_size=3, seed=7,
                 sentences=_corpus(3), subsampling=0)
    j.build_vocab()
    p.build_vocab()
    rng = np.random.RandomState(7 + 31)
    c, t = j._make_pairs_flat(*j._encode_flat(), rng)
    pairs, packed = p._neg_pairs()
    assert packed
    np.testing.assert_array_equal(pairs, c.astype(np.int32)
                                  | (t.astype(np.int32) << 16))


def test_lr_schedule_is_the_jax_formula():
    want = jw._lr_schedule(np, 0.025, 1e-4, 5, 12, 40.0).astype(np.float32)
    np.testing.assert_allclose(pw._lr_schedule(0.025, 1e-4, 5, 12, 40.0),
                               want, rtol=1e-7)


# ------------------------------------------------------------- one step

def _tables(V=11, D=8, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.rand(V, D).astype(np.float32) - 0.5),
            (rs.rand(V, D).astype(np.float32) - 0.5),
            rs.randint(0, V, size=64).astype(np.int32))


# centers repeat (rows 3 and 7 twice, row 1 three times): the scatter-adds
# must accumulate them
CENTERS = np.array([3, 7, 1, 3, 1, 9, 7, 1], np.int32)
CONTEXTS = np.array([2, 2, 5, 6, 0, 2, 4, 8], np.int32)
WEIGHTS = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


@pytest.mark.parametrize("shared", [True, False])
def test_sg_neg_step_matches_jax_given_its_draw(shared):
    syn0, syn1, table = _tables()
    key = jax.random.PRNGKey(5)
    K = 4
    jfn = jw._sg_neg_batch_shared if shared else jw._sg_neg_batch
    shape = (K,) if shared else (len(CENTERS), K)
    js0, js1 = jfn(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(table),
                   jnp.asarray(CENTERS), jnp.asarray(CONTEXTS),
                   jnp.float32(0.05), key, K, weights=jnp.asarray(WEIGHTS))
    draw = np.asarray(jax.random.randint(key, shape, 0, table.shape[0]))
    ps0, ps1 = _t(syn0), _t(syn1)
    pfn = pw._sg_neg_batch_shared if shared else pw._sg_neg_batch
    pfn(ps0, ps1, _t(table, torch.long), _t(CENTERS, torch.long),
        _t(CONTEXTS, torch.long), torch.tensor(0.05), _t(draw, torch.long),
        weights=_t(WEIGHTS))
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)


def test_scatter_adds_accumulate_a_repeated_row():
    """Every pair of the batch has the same center (and the HS paths the
    same points): the row moves by the sum of the eight updates, as JAX's
    ``.at[].add`` sums them. ``t[idx] +=`` would keep one of them."""
    syn0, syn1, table = _tables(seed=2)
    c = np.full(8, 4, np.int32)
    key = jax.random.PRNGKey(1)
    js0, js1 = jw._sg_neg_batch(jnp.asarray(syn0), jnp.asarray(syn1),
                                jnp.asarray(table), jnp.asarray(c),
                                jnp.asarray(CONTEXTS), jnp.float32(0.05),
                                key, 2)
    draw = np.asarray(jax.random.randint(key, (8, 2), 0, table.shape[0]))
    ps0, ps1 = _t(syn0), _t(syn1)
    pw._sg_neg_batch(ps0, ps1, _t(table, torch.long), _t(c, torch.long),
                     _t(CONTEXTS, torch.long), torch.tensor(0.05),
                     _t(draw, torch.long))
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)
    pts = np.tile(np.array([[2, 5]], np.int32), (8, 1))
    ones = np.ones((8, 2), np.float32)
    js0, js1 = jw._sg_hs_step(jnp.asarray(syn0), jnp.asarray(syn1),
                              jnp.asarray(c), jnp.asarray(pts),
                              jnp.asarray(ones * 0), jnp.asarray(ones),
                              jnp.float32(0.1))
    ps0, ps1 = _t(syn0), _t(syn1)
    pw._sg_hs_step(ps0, ps1, _t(c, torch.long), _t(pts, torch.long),
                   _t(ones * 0), _t(ones), np.float32(0.1))
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_sg_hs_step_matches_jax(normalize):
    syn0, syn1, _ = _tables(seed=3)
    rs = np.random.RandomState(4)
    pts = rs.randint(0, 11, size=(8, 3)).astype(np.int32)
    cds = rs.randint(0, 2, size=(8, 3)).astype(np.float32)
    msk = (rs.rand(8, 3) > 0.3).astype(np.float32)
    js0, js1 = jw._sg_hs_step(jnp.asarray(syn0), jnp.asarray(syn1),
                              jnp.asarray(CENTERS), jnp.asarray(pts),
                              jnp.asarray(cds), jnp.asarray(msk),
                              jnp.float32(0.1), normalize=normalize)
    ps0, ps1 = _t(syn0), _t(syn1)
    pw._sg_hs_step(ps0, ps1, _t(CENTERS, torch.long), _t(pts, torch.long),
                   _t(cds), _t(msk), np.float32(0.1), normalize=normalize)
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)


def _windows(seed=5, B=8, W=4):
    rs = np.random.RandomState(seed)
    ctx = rs.randint(0, 11, size=(B, W)).astype(np.int32)
    msk = (rs.rand(B, W) > 0.3).astype(np.float32)
    return ctx, msk


def test_cbow_neg_step_matches_jax_given_its_draw():
    syn0, syn1, table = _tables(seed=6)
    ctx, msk = _windows()
    key = jax.random.PRNGKey(9)
    js0, js1 = jw._cbow_neg_batch(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(table),
        jnp.asarray(ctx), jnp.asarray(msk), jnp.asarray(CONTEXTS),
        jnp.float32(0.05), key, 3, weights=jnp.asarray(WEIGHTS))
    draw = np.asarray(jax.random.randint(key, (8, 3), 0, table.shape[0]))
    ps0, ps1 = _t(syn0), _t(syn1)
    pw._cbow_neg_batch(ps0, ps1, _t(table, torch.long), _t(ctx, torch.long),
                       _t(msk), _t(CONTEXTS, torch.long), torch.tensor(0.05),
                       _t(draw, torch.long), weights=_t(WEIGHTS))
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)


def test_cbow_hs_step_matches_jax():
    syn0, syn1, _ = _tables(seed=7)
    ctx, msk = _windows(seed=8)
    rs = np.random.RandomState(9)
    pts = rs.randint(0, 11, size=(8, 3)).astype(np.int32)
    cds = rs.randint(0, 2, size=(8, 3)).astype(np.float32)
    cm = (rs.rand(8, 3) > 0.3).astype(np.float32)
    js0, js1 = jw._cbow_hs_batch(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(ctx),
        jnp.asarray(msk), jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(cm),
        jnp.float32(0.1), weights=jnp.asarray(WEIGHTS))
    ps0, ps1 = _t(syn0), _t(syn1)
    pw._cbow_hs_batch(ps0, ps1, _t(ctx, torch.long), _t(msk),
                      _t(pts, torch.long), _t(cds), _t(cm), np.float32(0.1),
                      weights=_t(WEIGHTS))
    np.testing.assert_allclose(ps0.numpy(), np.asarray(js0), STEP_RTOL,
                               STEP_ATOL)
    np.testing.assert_allclose(ps1.numpy(), np.asarray(js1), STEP_RTOL,
                               STEP_ATOL)


def test_infer_and_glove_steps_match_jax():
    syn0, syn1, table = _tables(seed=10)
    key = jax.random.PRNGKey(2)
    docs = np.zeros(8, np.int32)
    jdv = jw._sg_infer_step(jnp.asarray(syn0[:1]), jnp.asarray(syn1),
                            jnp.asarray(table), jnp.asarray(docs),
                            jnp.asarray(CONTEXTS), jnp.float32(0.05), key, 3)
    draw = np.asarray(jax.random.randint(key, (8, 3), 0, table.shape[0]))
    pdv = _t(syn0[:1])
    pw._sg_infer_step(pdv, _t(syn1), _t(table, torch.long),
                      _t(docs, torch.long), _t(CONTEXTS, torch.long),
                      np.float32(0.05), _t(draw, torch.long))
    np.testing.assert_allclose(pdv.numpy(), np.asarray(jdv), STEP_RTOL,
                               STEP_ATOL)

    rs = np.random.RandomState(11)
    V, D = 11, 8
    tabs = [rs.rand(V, D).astype(np.float32) - 0.5,
            rs.rand(V, D).astype(np.float32) - 0.5,
            rs.rand(V).astype(np.float32), rs.rand(V).astype(np.float32),
            rs.rand(V, D).astype(np.float32), rs.rand(V, D).astype(np.float32),
            rs.rand(V).astype(np.float32), rs.rand(V).astype(np.float32)]
    logx = rs.rand(8).astype(np.float32)
    fx = rs.rand(8).astype(np.float32)
    jout = jg._glove_step(*[jnp.asarray(a) for a in tabs],
                          jnp.asarray(CENTERS), jnp.asarray(CONTEXTS),
                          jnp.asarray(logx), jnp.asarray(fx),
                          jnp.float32(0.05))
    pt = [_t(a) for a in tabs]
    pg._glove_step(*pt, _t(CENTERS, torch.long), _t(CONTEXTS, torch.long),
                   _t(logx), _t(fx), 0.05)
    for a, b in zip(jout, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), STEP_RTOL,
                                   STEP_ATOL)


# ----------------------------------------------------------- end to end

@pytest.mark.parametrize("algo,epochs", [("skipgram", 3), ("cbow", 8)])
def test_hierarchical_softmax_fit_matches_jax(algo, epochs):
    j, p = _pair(min_word_frequency=3, layer_size=24, window_size=3,
                 epochs=epochs, use_hierarchic_softmax=True, seed=7,
                 sentences=_corpus(), subsampling=0,
                 elements_learning_algorithm=algo)
    j.fit()
    p.fit()
    np.testing.assert_allclose(p.syn0.numpy(), np.asarray(j.syn0),
                               rtol=1e-4, atol=HS_ATOL)
    np.testing.assert_allclose(p.syn1.numpy(), np.asarray(j.syn1),
                               rtol=1e-4, atol=HS_ATOL)
    if algo == "skipgram":
        assert p.similarity("cat", "kitten") > p.similarity("cat", "market")
    else:
        assert p.similarity("stocks", "market") > \
            p.similarity("stocks", "kitten") + 0.1


def test_glove_fit_matches_jax():
    j, p = _pair("Glove", min_word_frequency=3, layer_size=24, window_size=4,
                 epochs=8, seed=7, sentences=_corpus(), subsampling=0)
    j.fit()
    p.fit()
    np.testing.assert_allclose(p.syn0.numpy(), np.asarray(j.syn0),
                               rtol=1e-5, atol=GLOVE_ATOL)
    assert p.similarity("cat", "kitten") > p.similarity("cat", "stocks")


class _JaxDraws:
    """The JAX package's device draws, in the port's call order: a draw
    splits its chain's key and draws from the new subkey, as JAX's scans
    do; ``chains`` gives (key, number of draws) in order, None for no
    end. Its ``negatives`` / ``permutation`` stand in for the port's
    ``_draw_negatives`` / ``_draw_permutation``."""

    def __init__(self, chains):
        self._chains = iter(chains)
        self._key, self._left = next(self._chains)

    def _sub(self):
        if self._left == 0:
            self._key, self._left = next(self._chains)
        self._key, sub = jax.random.split(self._key)
        if self._left is not None:
            self._left -= 1
        return sub

    def negatives(self, gen, shape, table_size, device):
        return _t(jax.random.randint(self._sub(), shape, 0, table_size),
                  torch.long)

    def permutation(self, gen, n, device):
        return _t(jax.random.permutation(self._sub(), n), torch.long)

    def spent(self):
        return self._left in (0, None) and next(self._chains, None) is None


def _epoch_keys(key, epochs):
    """The subkey JAX splits off for each epoch's scan."""
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        yield sub


def _assert_tables(p_tabs, j_tabs):
    for a, b in zip(p_tabs, j_tabs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), STEP_RTOL,
                                   STEP_ATOL)


@pytest.mark.parametrize("mode", ["shared", "per_pair", "cbow"])
def test_neg_fit_matches_jax_given_its_draws(monkeypatch, mode):
    """A whole NEG fit, two epochs, with JAX's negatives and (skip-gram)
    its device shuffle: skip-gram's key is split once, then every
    shuffle and step splits it in turn; CBOW splits a key an epoch."""
    kw = dict(min_word_frequency=3, layer_size=24, window_size=3, epochs=2,
              negative=5, seed=7, sentences=_corpus(10), subsampling=0,
              negative_sharing=mode == "shared",
              elements_learning_algorithm="cbow" if mode == "cbow"
              else "skipgram")
    j, p = _pair(**kw)
    j.fit()
    p.build_vocab()
    if mode == "cbow":
        rng = np.random.RandomState(7 + 31)
        n = len(p._make_cbow_windows(p._encode_corpus(), rng)[2])
        S = -(-n // p._effective_batch())
        draws = _JaxDraws((k, S) for k in
                          _epoch_keys(jax.random.PRNGKey(7), 2))
    else:
        draws = _JaxDraws([(jax.random.split(jax.random.PRNGKey(7))[1],
                            None)])
    monkeypatch.setattr(pw, "_draw_negatives", draws.negatives)
    monkeypatch.setattr(pw, "_draw_permutation", draws.permutation)
    p.fit()
    assert draws.spent()
    _assert_tables((p.syn0, p.syn1), (j.syn0, j.syn1))


@pytest.mark.parametrize("slots", [1, 4])
def test_distributed_word2vec_matches_jax_given_its_draws(monkeypatch,
                                                          slots):
    """``DistributedWord2Vec`` against JAX's over as many CPU devices:
    8 batches an epoch padded to 3 chunks of 3, two epochs, so the column
    split, the padded batch, the scaled LR schedule over the 9-step
    epochs and six averagings all reach the tables. Slot g draws from
    JAX's epoch key folded with g."""
    kw = dict(averaging_frequency=3, min_word_frequency=3, layer_size=24,
              window_size=3, epochs=2, seed=7, sentences=_corpus(10),
              subsampling=0)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:slots]), ("data",))
    j = J.DistributedWord2Vec(mesh=jmesh, **kw).fit()
    mesh = Mesh([Slot(0, torch.device("cpu"))] * slots, ("data",), (slots,))
    p = P.DistributedWord2Vec(mesh=mesh, device="cpu", **kw)
    p.build_vocab()
    n = len(p._make_pairs(p._encode_corpus(),
                          np.random.RandomState(7 + 31))[0])
    bs = max(slots, p._effective_batch() // slots * slots)
    batches = -(-n // bs)
    S = -(-batches // 3) * 3                 # whole chunks of 3 batches
    assert (batches, S) == (8, 9)
    epochs = list(_epoch_keys(jax.random.PRNGKey(7), 2))
    per_slot = [_JaxDraws([(jax.random.fold_in(k, g), S) for k in epochs])
                for g in range(slots)]
    slot_of = {}

    def negatives(gen, shape, table_size, device):
        g = slot_of.setdefault(id(gen), len(slot_of))
        return per_slot[g].negatives(gen, shape, table_size, device)

    monkeypatch.setattr(pdw, "_draw_negatives", negatives)
    p.fit()
    assert len(slot_of) == slots and all(d.spent() for d in per_slot)
    _assert_tables((p.syn0, p.syn1), (j.syn0, j.syn1))


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_match_jax_given_its_draws(monkeypatch, algo):
    """Two epochs of PV-DBOW (then the word vectors' skip-gram fit) or
    PV-DM, and ``infer_vector``, each with JAX's draws: doc vectors,
    word and context tables and the inferred vector."""
    docs = _corpus(10)
    labels = [f"cats_{i}" if "cat" in d or "kitten" in d else f"fin_{i}"
              for i, d in enumerate(docs)]
    kw = dict(sequences_learning_algorithm=algo, min_word_frequency=3,
              layer_size=24, window_size=3, seed=7, sentences=docs,
              labels=labels, subsampling=0, epochs=2)
    j, p = _pair("ParagraphVectors", **kw)
    j.fit()
    p.build_vocab()
    seqs = p._encode_corpus()
    if algo == "dbow":
        n = sum(len(s) for s in seqs)
        word_fit = [(jax.random.split(jax.random.PRNGKey(7))[1], None)]
    else:
        rng = np.random.RandomState(7 + 41)
        rng.rand(len(seqs), 24)              # the doc vectors' draw
        n = len(p._make_cbow_windows(seqs, rng, with_sids=True)[2])
        word_fit = []
    S = -(-n // p._effective_batch())
    draws = _JaxDraws([(k, S) for k in _epoch_keys(jax.random.PRNGKey(8), 2)]
                      + word_fit)
    monkeypatch.setattr(pw, "_draw_negatives", draws.negatives)
    monkeypatch.setattr(pw, "_draw_permutation", draws.permutation)
    p.fit()
    assert draws.spent()
    _assert_tables((p.doc_vecs, p.syn0, p.syn1),
                   (j.doc_vecs, j.syn0, j.syn1))
    init = (np.random.RandomState(7 + 41).rand(len(seqs), 24)
            .astype(np.float32) - 0.5) / 24
    assert np.abs(p.doc_vecs.numpy() - init).max() > 100 * STEP_ATOL

    text = "the cat and the kitten on the mat"
    draws = _JaxDraws([(jax.random.PRNGKey(7 + 5), None)])
    monkeypatch.setattr(ppv, "_draw_negatives", draws.negatives)
    np.testing.assert_allclose(p.infer_vector(text), j.infer_vector(text),
                               STEP_RTOL, STEP_ATOL)


@pytest.mark.parametrize("sharing", [True, False])
def test_skipgram_neg_clusters(sharing):
    """The JAX suite's skip-gram checks, shared and per-pair negatives."""
    w2v = P.Word2Vec(min_word_frequency=3, layer_size=32, window_size=3,
                     epochs=3, negative=5, seed=7, sentences=_corpus(),
                     subsampling=0, negative_sharing=sharing, device="cpu")
    w2v.fit()
    assert w2v.similarity("cat", "kitten") > w2v.similarity("cat", "stocks")
    assert w2v.similarity("market", "stocks") > \
        w2v.similarity("market", "mat")
    assert any(w in w2v.words_nearest("cat", 5) for w in ("kitten", "mat"))


def test_cbow_neg_clusters():
    w2v = P.Word2Vec(min_word_frequency=3, layer_size=24, window_size=3,
                     epochs=8, seed=7, sentences=_corpus(), subsampling=0,
                     elements_learning_algorithm="cbow", device="cpu")
    w2v.fit()
    assert w2v.similarity("stocks", "market") > \
        w2v.similarity("stocks", "kitten") + 0.1


def test_neg_fit_repeats_for_a_seed_and_trains_the_jax_init():
    kw = dict(min_word_frequency=3, layer_size=16, window_size=3, epochs=1,
              seed=7, sentences=_corpus(10), subsampling=0, device="cpu")
    a = P.Word2Vec(**kw).fit()
    b = P.Word2Vec(**kw).fit()
    assert torch.equal(a.syn0, b.syn0)
    j = J.Word2Vec(**{k: v for k, v in kw.items() if k != "device"})
    j.build_vocab()
    j._init_tables()
    assert not np.allclose(a.syn0.numpy(), np.asarray(j.syn0))
    assert np.abs(a.syn0.numpy() - np.asarray(j.syn0)).max() < 1.0


def test_degenerate_corpora():
    w = P.Word2Vec(min_word_frequency=1, layer_size=8, subsampling=0,
                   sentences=["hello"], seed=1, device="cpu")
    w.fit()
    assert w.syn0 is not None
    sents = ["a b c d e", "b c d e f"] * 10
    w = P.Word2Vec(min_word_frequency=1, layer_size=8, subsampling=0,
                   sentences=sents, seed=1, device="cpu")
    w.build_vocab()
    flat1, _ = w._encode_tokens()
    sents[0] = "f e d c b"          # in-place mutation, same length
    flat2, _ = w._encode_tokens()
    assert not np.array_equal(flat1[:5], flat2[:5])


def test_cjk_tokenizer_word2vec():
    tf = P.CJKTokenizerFactory()
    assert tf.create("我爱机器学习 and jax").get_tokens() == \
        J.CJKTokenizerFactory().create("我爱机器学习 and jax").get_tokens()
    rs = np.random.RandomState(3)
    animals = "小猫 小狗 宠物 毛皮".split()
    tech = "电脑 程序 代码 芯片".split()
    sentences = ["".join(rs.choice(animals if rs.rand() < 0.5 else tech,
                                   size=6)) for _ in range(300)]
    w2v = P.Word2Vec(min_word_frequency=3, layer_size=16, window_size=3,
                     negative=5, epochs=3, seed=2, subsampling=0,
                     sentences=sentences, device="cpu",
                     tokenizer_factory=P.CJKTokenizerFactory())
    w2v.fit()
    words = set(w2v.vocab.words())
    assert any(any(c in w for c in "猫狗宠毛") for w in words)
    assert np.isfinite(w2v.syn0.numpy()).all()


# ------------------------------------------------------ serializer, docs

@pytest.mark.parametrize("fmt", ["txt", "npz"])
def test_word_vector_files_cross_both_ways(tmp_path, fmt):
    j, p = _pair(min_word_frequency=3, layer_size=16, epochs=1, seed=7,
                 sentences=_corpus(10), subsampling=0,
                 use_hierarchic_softmax=True)
    j.fit()
    p.fit()
    for writer, reader, model in (
            (J.WordVectorSerializer, P.WordVectorSerializer, j),
            (P.WordVectorSerializer, J.WordVectorSerializer, p)):
        path = tmp_path / f"{type(writer).__module__}.{fmt}"
        if fmt == "txt":
            writer.write_word_vectors(model, path)
            loaded = reader.read_word_vectors(path)
        else:
            writer.write_npz(model, str(path))
            loaded = reader.read_npz(str(path))
        assert loaded.vocab.words() == model.vocab.words()
        np.testing.assert_allclose(loaded.word_vector("cat"),
                                   model.word_vector("cat"), atol=1e-6)
        assert loaded.words_nearest("cat", 3) == model.words_nearest("cat", 3)


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors(algo):
    docs = _corpus(20)
    labels = [f"cats_{i}" if "cat" in d or "kitten" in d else f"fin_{i}"
              for i, d in enumerate(docs)]
    kw = dict(sequences_learning_algorithm=algo, min_word_frequency=3,
              layer_size=24, window_size=3, seed=7, sentences=docs,
              labels=labels, subsampling=0)
    # no epoch: both packages' tables are their numpy draws, bitwise
    j0, p0 = _pair("ParagraphVectors", epochs=0, **kw)
    j0.fit()
    p0.fit()
    np.testing.assert_array_equal(p0.doc_vecs.numpy(),
                                  np.asarray(j0.doc_vecs))
    np.testing.assert_array_equal(p0.syn0.numpy(), np.asarray(j0.syn0))
    pv = P.ParagraphVectors(device="cpu", epochs=2, **kw).fit()
    dv = pv.doc_vector(labels[0])
    assert dv is not None and dv.shape == (24,)
    assert not np.array_equal(dv, p0.doc_vector(labels[0]))
    inferred = pv.infer_vector("the cat and the kitten on the mat")
    assert inferred.shape == (24,) and np.isfinite(inferred).all()
    assert len(pv.nearest_labels(inferred, 3)) == 3


# ------------------------------------------------------------ distributed

@pytest.mark.parametrize("slots", [1, 4])
def test_distributed_word2vec_on_a_cpu_mesh(slots):
    mesh = Mesh([Slot(0, torch.device("cpu"))] * slots, ("data",), (slots,))

    def train():
        return P.DistributedWord2Vec(
            mesh=mesh, averaging_frequency=4, min_word_frequency=3,
            layer_size=24, window_size=3, epochs=3 if slots > 1 else 2,
            seed=7, sentences=_corpus(), subsampling=0, device="cpu").fit()

    w2v = train()
    assert w2v.similarity("stocks", "market") > \
        w2v.similarity("stocks", "kitten")
    if slots > 1:
        assert w2v.similarity("cat", "kitten") > \
            w2v.similarity("cat", "market")
        again = train()
        assert torch.equal(w2v.syn0, again.syn0)


def test_distributed_word2vec_rejects_hs():
    with pytest.raises(NotImplementedError):
        P.DistributedWord2Vec(use_hierarchic_softmax=True, sentences=["a b"],
                              device="cpu")


# --------------------------------------------------- CNN sentence iterator

@pytest.mark.parametrize("unknown", ["remove_word", "use_unknown_vector"])
def test_cnn_sentence_iterator_datasets_equal(tmp_path, unknown):
    w2v = P.Word2Vec(min_word_frequency=3, layer_size=8, epochs=1, seed=7,
                     sentences=_corpus(4), subsampling=0,
                     use_hierarchic_softmax=True, device="cpu").fit()
    path = tmp_path / "v.txt"
    P.WordVectorSerializer.write_word_vectors(w2v, path)
    jvec = J.WordVectorSerializer.read_word_vectors(path)
    pvec = P.WordVectorSerializer.read_word_vectors(path)
    data = [(s, "cats" if "cat" in s else "fin")
            for s in _corpus(2) + ["zebra quokka cat", "unseen words only"]]
    it_j = J.CnnSentenceDataSetIterator(data, jvec, batch_size=5,
                                        max_sentence_length=6,
                                        unknown_word_handling=unknown)
    it_p = P.CnnSentenceDataSetIterator(data, pvec, batch_size=5,
                                        max_sentence_length=6,
                                        unknown_word_handling=unknown)
    js, ps = list(it_j), list(it_p)
    assert len(js) == len(ps) > 0
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.features_mask, b.features_mask)
    np.testing.assert_array_equal(
        it_j.load_single_sentence("the cat sat"),
        it_p.load_single_sentence("the cat sat"))


# ------------------------------------------------------------- segmenters

SEGMENT_CASES = [
    ("zh", "我们喜欢使用机器学习和自然语言处理"),
    ("zh", "机器学习模型"),
    ("ja", "私は機械学習が好きです"),
    ("zh", "深度学习模型在TPU hardware上训练"),
]


@pytest.mark.parametrize("lang,text", SEGMENT_CASES)
def test_segmenters_match_jax(lang, text):
    assert pseg.DictionarySegmenterTokenizerFactory(lang).create(
        text).get_tokens() == jseg.DictionarySegmenterTokenizerFactory(
            lang).create(text).get_tokens()


def test_segmenter_rules_and_bundled_lexicons():
    assert pseg.MaxMatchSegmenter(["机器学习"]).segment("机器学习硬件") == \
        ["机器学习", "硬", "件"]
    assert pseg.MaxMatchSegmenter(["研究", "研究生", "生命"]).segment(
        "研究生命") == ["研究", "生命"]
    assert pseg.DictionarySegmenterTokenizerFactory(
        lexicon=["深度", "学习"]).create("深度学习").get_tokens() == \
        ["深度", "学习"]
    for lang in ("zh", "ja"):
        assert pseg.load_bundled_lexicon(lang) == \
            jseg.load_bundled_lexicon(lang)
    assert pseg._DATA_DIR != jseg._DATA_DIR
    sents = ["我们喜欢机器学习", "我们研究自然语言处理",
             "机器学习模型训练数据", "自然语言处理使用词向量"] * 12
    seg = pseg.DictionarySegmenterTokenizerFactory("zh")
    w2v = P.Word2Vec(min_word_frequency=5, layer_size=16, window_size=2,
                     epochs=1, negative=2, seed=3, subsampling=0,
                     sentences=sents, device="cpu", tokenizer_factory=seg)
    w2v.build_vocab()
    assert {"机器学习", "我们", "自然语言处理", "训练"} <= set(w2v.vocab.words())
    w2v.fit()
    assert np.isfinite(w2v.syn0.numpy()).all()


def test_huffman_codes_equal_jax():
    tf = J.DefaultTokenizerFactory()
    seqs = [tf.create(s).get_tokens() for s in _corpus(2)]
    jv = J.VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    pv = P.VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    j_huffman(jv)
    p_huffman(pv)
    assert [(w.codes, w.points) for w in jv.vocab_words()] == \
        [(w.codes, w.points) for w in pv.vocab_words()]
