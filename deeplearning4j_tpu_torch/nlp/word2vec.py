"""Word2Vec: skip-gram / CBOW with negative sampling or hierarchical softmax.

Counterpart of deeplearning4j_tpu/nlp/word2vec.py (parity surface: the
reference's Word2Vec.java builder, SkipGram.java and CBOW.java,
InMemoryLookupTable, subsampling and LR decay in SequenceVectors.fit).

The corpus becomes (center, context) index batches on the host, with the
JAX package's numpy draws in its order, so vocabularies, Huffman codes,
pairs, windows and initial tables are bitwise the same in both packages.
The tables live on the network's device (the card unless ``device=``
says otherwise) and each batch is gather, dot, sigmoid and scatter-add
in plain tensor code; no hand kernel runs here, as none runs in the JAX
package's (``jnp``, no Pallas). Scatter-adds go through ``_scatter_add``
(an accumulating ``index_put_``), which sums a row that appears twice in a
batch, as ``.at[].add`` does in JAX, where ``t[idx] +=`` would keep only
one of the writes, and sums it in the same order on every run.

The draws on the device (the negatives, and the skip-gram NEG epoch's
shuffle) come from an explicit ``torch.Generator`` where the JAX package
uses ``jax.random``. Each NEG step's draw is split from its update
(``_draw_negatives``; the ``*_batch`` functions take the drawn indices
into the unigram table), and the epoch shuffle is drawn by
``_draw_permutation``, so a test can feed the updates the indices JAX
drew. The hierarchical-softmax paths draw nothing on the device.

The skip-gram NEG fit stages the packed pairs on the device once (the JAX
package's ``packed`` rule) and shuffles them there every epoch; its steps
are a host loop of launches (the JAX package scans all epochs in one XLA
dispatch).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CommonPreprocessor, DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache, VocabConstructor, build_huffman, unigram_table)
from deeplearning4j_tpu_torch.ops import resolve_device


def _scatter_add(t: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """``t[idx] += x`` along dim 0 with every repeated row of ``idx``
    accumulated (the JAX package's ``.at[idx].add``), in place. The
    accumulating ``index_put_`` sorts the indices on the card and sums each
    row's updates in a fixed order, so a run repeats bit for bit; the
    card's ``index_add_`` adds them with atomics in no fixed order."""
    return t.index_put_((idx,), x, accumulate=True)


def _lr_schedule(lr0, lr_min, step0, S, total) -> np.ndarray:
    """Linear LR decay clamped at ``lr_min``: the schedule of every NEG
    path, (S,) float32 for steps ``step0 .. step0 + S - 1`` of ``total``."""
    return np.maximum(
        lr_min, lr0 * (1.0 - (step0 + np.arange(S, dtype=np.float32))
                       / total)).astype(np.float32)


def _draw_negatives(gen: torch.Generator, shape, table_size: int,
                    device) -> torch.Tensor:
    """Indices into the unigram table for one NEG step (the JAX package's
    ``jax.random.randint(key, shape, 0, table.shape[0])``)."""
    return torch.randint(0, table_size, shape, generator=gen, device=device)


def _draw_permutation(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """The skip-gram NEG fit's epoch shuffle of ``n`` staged pairs (the
    JAX package's ``jax.random.permutation(key, n)``)."""
    return torch.randperm(n, generator=gen, device=device)


def _sg_neg_batch_shared(syn0, syn1neg, table, centers, contexts, lr, draw,
                         weights=None):
    """Skip-gram NEG batch with BATCH-SHARED negatives, in place: one draw
    of ``negative`` table indices (``draw``, (K,)) serves every pair of the
    batch, so the negative traffic is three small matmuls and a K-row
    update (the JAX package's candidate sharing)."""
    v = syn0[centers]                      # (B, D)
    u_pos = syn1neg[contexts]              # (B, D)
    s_pos = torch.sigmoid((v * u_pos).sum(-1))
    g_pos = (1.0 - s_pos) * lr
    if weights is not None:
        g_pos = g_pos * weights
    dv = g_pos[:, None] * u_pos
    du_pos = g_pos[:, None] * v
    negs = table[draw]
    u_neg = syn1neg[negs]                  # (K, D)
    s_neg = torch.sigmoid(v @ u_neg.T)     # (B, K)
    g_neg = -s_neg * lr
    if weights is not None:
        g_neg = g_neg * weights[:, None]
    dv = dv + g_neg @ u_neg                # (B, D)
    du_neg = g_neg.T @ v                   # (K, D)
    _scatter_add(syn0, centers, dv)
    _scatter_add(syn1neg, contexts, du_pos)
    _scatter_add(syn1neg, negs, du_neg)


def _sg_neg_batch(syn0, syn1neg, table, centers, contexts, lr, draw,
                  weights=None):
    """One skip-gram negative-sampling batch with per-pair negatives, in
    place. centers/contexts: (B,); ``draw``: (B, K) indices into the
    unigram table; weights: optional (B,) 0/1 pair weights (0 = a padding
    pair, which contributes nothing)."""
    B, K = draw.shape
    v = syn0[centers]                      # (B, D)
    u_pos = syn1neg[contexts]              # (B, D)
    s_pos = torch.sigmoid((v * u_pos).sum(-1))
    g_pos = (1.0 - s_pos) * lr             # (B,)
    if weights is not None:
        g_pos = g_pos * weights
    dv = g_pos[:, None] * u_pos
    du_pos = g_pos[:, None] * v
    negs = table[draw]                     # (B, K)
    u_neg = syn1neg[negs]                  # (B, K, D)
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", v, u_neg))
    g_neg = -s_neg * lr                    # (B, K)
    if weights is not None:
        g_neg = g_neg * weights[:, None]
    dv = dv + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    du_neg = g_neg[..., None] * v[:, None, :]
    # positive-context and negative-sample rows in one scatter on syn1neg
    _scatter_add(syn0, centers, dv)
    _scatter_add(syn1neg, torch.cat([contexts, negs.reshape(-1)]),
                 torch.cat([du_pos, du_neg.reshape(B * K, -1)]))


def _sg_neg_fit(syn0, syn1neg, table, pairs, lr0, lr_min, gen, negative, bs,
                shared=True, packed=False, epochs=1):
    """Every epoch of NEG skip-gram over ``pairs`` staged on the device
    once: a fresh device shuffle an epoch, padded to whole batches of
    ``bs`` (pad weight 0), then one step a batch, in place."""
    if packed:
        centers = pairs & 0xFFFF
        contexts = pairs >> 16
    else:
        centers, contexts = pairs[0], pairs[1]
    dev = centers.device
    n = centers.shape[0]
    S = -(-n // bs)
    pad = S * bs - n
    total = float(max(1, epochs * S))
    step_fn = _sg_neg_batch_shared if shared else _sg_neg_batch
    w = torch.cat([torch.ones(n, device=dev),
                   torch.zeros(pad, device=dev)]).reshape(S, bs)
    for ep in range(epochs):
        idx = _draw_permutation(gen, n, dev)
        sel = torch.cat([idx, torch.zeros(pad, dtype=idx.dtype, device=dev)])
        c = centers[sel].reshape(S, bs)
        t = contexts[sel].reshape(S, bs)
        lrs = torch.from_numpy(
            _lr_schedule(lr0, lr_min, ep * S, S, total)).to(dev)
        shape = (negative,) if shared else (bs, negative)
        for s in range(S):
            draw = _draw_negatives(gen, shape, table.shape[0], dev)
            step_fn(syn0, syn1neg, table, c[s], t[s], lrs[s], draw,
                    weights=w[s])


def _sg_neg_epoch(syn0, syn1neg, table, centers_b, contexts_b, weights_b,
                  lrs, gen, negative):
    """A whole epoch of per-pair skip-gram NEG batches, in place.
    centers_b/contexts_b/weights_b: (S, B); lrs: (S,) per-batch LR."""
    S, B = centers_b.shape
    for s in range(S):
        draw = _draw_negatives(gen, (B, negative), table.shape[0],
                               syn0.device)
        _sg_neg_batch(syn0, syn1neg, table, centers_b[s], contexts_b[s],
                      lrs[s], draw, weights=weights_b[s])


def _sg_infer_step(dv, syn1neg, table, docs, words, lr, draw):
    """Skip-gram step that updates ONLY the doc / center table ``dv`` in
    place (syn1neg stays frozen): ParagraphVectors.infer_vector's step.
    ``draw``: (B, K) indices into the unigram table."""
    v = dv[docs]
    u_pos = syn1neg[words]
    s_pos = torch.sigmoid((v * u_pos).sum(-1))
    delta = ((1.0 - s_pos) * lr)[:, None] * u_pos
    u_neg = syn1neg[table[draw]]
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", v, u_neg))
    delta = delta + torch.einsum("bk,bkd->bd", -s_neg * lr, u_neg)
    _scatter_add(dv, docs, delta)


def _sg_hs_step(syn0, syn1, centers, points, codes, code_mask, lr, *,
                normalize=False):
    """Skip-gram hierarchical-softmax batch, in place.
    points/codes/code_mask: (B, L) padded Huffman paths of the CONTEXT
    word; centers: (B,) input word indices.

    ``normalize=True`` divides each scatter-add by the index's occurrence
    count in the batch: a batched scatter-add SUMS co-located gradients
    where the reference's sequential pairs self-limit through the updated
    sigmoid, and on dense small graphs (DeepWalk's regime) the Huffman
    root collects thousands of summed updates without it."""
    v = syn0[centers]                      # (B, D)
    u = syn1[points]                       # (B, L, D)
    s = torch.sigmoid(torch.einsum("bd,bld->bl", v, u))
    # grad of -log p: (1 - code - sigmoid)
    g = (1.0 - codes - s) * lr * code_mask
    dv = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * v[:, None, :]
    B, L = points.shape
    flat_p = points.reshape(-1)
    du = du.reshape(B * L, -1)
    if normalize:
        cnt_c = _scatter_add(torch.zeros(syn0.shape[0], device=syn0.device),
                             centers, torch.ones(B, device=syn0.device))
        dv = dv / cnt_c[centers][:, None]
        cnt_p = _scatter_add(torch.zeros(syn1.shape[0], device=syn1.device),
                             flat_p, code_mask.reshape(-1))
        du = du / torch.clamp(cnt_p[flat_p], min=1.0)[:, None]
    _scatter_add(syn0, centers, dv)
    _scatter_add(syn1, flat_p, du)


def _cbow_neg_batch(syn0, syn1neg, table, context_mat, context_mask, targets,
                    lr, draw, weights=None):
    """CBOW NEG batch, in place: the mean of the context vectors predicts
    the target. context_mat: (B, W) padded window indices; context_mask:
    (B, W); ``draw``: (B, K) indices into the unigram table; weights:
    optional (B,) 0/1 row weights (0 = a padding row)."""
    B, W = context_mat.shape
    K = draw.shape[1]
    ctx = syn0[context_mat]                      # (B, W, D)
    denom = torch.clamp(context_mask.sum(-1, keepdim=True), min=1.0)
    h = (ctx * context_mask[..., None]).sum(1) / denom   # (B, D)
    u_pos = syn1neg[targets]
    s_pos = torch.sigmoid((h * u_pos).sum(-1))
    g_pos = (1.0 - s_pos) * lr
    if weights is not None:
        g_pos = g_pos * weights
    dh = g_pos[:, None] * u_pos
    du_pos = g_pos[:, None] * h
    negs = table[draw]
    u_neg = syn1neg[negs]
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u_neg))
    g_neg = -s_neg * lr
    if weights is not None:
        g_neg = g_neg * weights[:, None]
    dh = dh + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    du_neg = g_neg[..., None] * h[:, None, :]
    # distribute dh back to the context words (divided by window count)
    dctx = (dh / denom)[:, None, :] * context_mask[..., None]
    _scatter_add(syn0, context_mat.reshape(-1), dctx.reshape(B * W, -1))
    _scatter_add(syn1neg, targets, du_pos)
    _scatter_add(syn1neg, negs.reshape(-1), du_neg.reshape(B * K, -1))


def _cbow_hs_batch(syn0, syn1, context_mat, context_mask, points, codes,
                   code_mask, lr, weights=None):
    """CBOW + hierarchical softmax batch, in place (parity: the reference's
    CBOW.java:138, the codes/points branch of iterateSample, on the mean
    context vector): the skip-gram HS math with the input side the masked
    context mean and the Huffman path the TARGET word's.
    points/codes/code_mask: (B, L)."""
    B, W = context_mat.shape
    ctx = syn0[context_mat]                      # (B, W, D)
    denom = torch.clamp(context_mask.sum(-1, keepdim=True), min=1.0)
    h = (ctx * context_mask[..., None]).sum(1) / denom   # (B, D)
    u = syn1[points]                             # (B, L, D)
    s = torch.sigmoid(torch.einsum("bd,bld->bl", h, u))
    g = (1.0 - codes - s) * lr * code_mask       # grad of -log p
    if weights is not None:
        g = g * weights[:, None]
    dh = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * h[:, None, :]
    dctx = (dh / denom)[:, None, :] * context_mask[..., None]
    _scatter_add(syn0, context_mat.reshape(-1), dctx.reshape(B * W, -1))
    _scatter_add(syn1, points.reshape(-1), du.reshape(-1, du.shape[-1]))


def _cbow_hs_epoch(syn0, syn1, ctxs_b, masks_b, pts_b, cds_b, cmsk_b,
                   weights_b, lrs):
    """A whole epoch of CBOW-HS batches, in place.
    ctxs_b/masks_b: (S, B, W); pts_b/cds_b/cmsk_b: (S, B, L);
    weights_b: (S, B); lrs: (S,)."""
    for s in range(ctxs_b.shape[0]):
        _cbow_hs_batch(syn0, syn1, ctxs_b[s], masks_b[s], pts_b[s], cds_b[s],
                       cmsk_b[s], lrs[s], weights=weights_b[s])


def _cbow_neg_epoch(syn0, syn1neg, table, ctxs_b, masks_b, targets_b,
                    weights_b, lrs, gen, negative):
    """A whole epoch of CBOW NEG batches, in place. ctxs_b/masks_b:
    (S, B, W); targets_b/weights_b: (S, B); lrs: (S,)."""
    S, B = targets_b.shape
    for s in range(S):
        draw = _draw_negatives(gen, (B, negative), table.shape[0],
                               syn0.device)
        _cbow_neg_batch(syn0, syn1neg, table, ctxs_b[s], masks_b[s],
                        targets_b[s], lrs[s], draw, weights=weights_b[s])


class Word2Vec:
    """Builder-style Word2Vec (parity: Word2Vec.Builder); its tables on
    ``device`` (default: the card)."""

    def __init__(self, min_word_frequency=5, layer_size=100, window_size=5,
                 learning_rate=0.025, min_learning_rate=1e-4, negative=5,
                 use_hierarchic_softmax=False, epochs=1, batch_size=4096,
                 subsampling=1e-3, seed=123, elements_learning_algorithm="skipgram",
                 iterate=None, tokenizer_factory=None, sentences=None,
                 negative_sharing=True, device=None):
        """``negative_sharing=True`` (default) draws each batch's negative
        samples once for the whole batch (candidate sharing): the same
        unigram distribution in expectation, with the negative term
        correlated across the batch's pairs (a documented divergence from
        the reference's per-pair sampling, as in the JAX package). Set
        False for strict per-pair sampling."""
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.epochs = epochs
        self.batch_size = batch_size
        self.subsampling = subsampling
        self.seed = seed
        self.algorithm = elements_learning_algorithm.lower()
        self.iterate = iterate
        self.sentences = sentences
        self.negative_sharing = negative_sharing
        self.device = resolve_device(device)
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory().set_token_pre_processor(CommonPreprocessor())
        self.vocab: Optional[VocabCache] = None
        self.syn0 = None
        self.syn1 = None
        self._norm_cache = None

    def _generator(self, offset: int = 0) -> torch.Generator:
        """The device draws' generator, seeded from the model's seed."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed + offset)

    def _to_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ----------------------------------------------------------- vocab + data
    def _sequences(self):
        if self.sentences is not None:
            src = self.sentences
        elif self.iterate is not None:
            src = self.iterate
        else:
            raise ValueError("No corpus: provide sentences=[...] or iterate=")
        for s in src:
            toks = self.tokenizer_factory.create(s).get_tokens()
            if toks:
                yield toks

    def build_vocab(self):
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(
            self._sequences())
        if self.use_hs:
            build_huffman(self.vocab)
        return self

    def _init_tables(self):
        rng = np.random.RandomState(self.seed)
        V, D = self.vocab.num_words(), self.layer_size
        self.syn0 = self._to_dev(
            (rng.rand(V, D).astype(np.float32) - 0.5) / D)
        self.syn1 = torch.zeros((V, D), device=self.device)
        self._table = self._to_dev(unigram_table(self.vocab))

    def _keep_probs(self) -> np.ndarray:
        """Per-vocab-index subsampling keep probability (Mikolov formula,
        parity: the reference's per-word ``ran`` threshold)."""
        vocab = self.vocab
        total = max(vocab.total_word_count, 1)
        counts = np.array([vocab._by_index[i].count
                           for i in range(vocab.num_words())], np.float64)
        if not self.subsampling or self.subsampling <= 0:
            return np.ones(len(counts))
        f = counts / total
        with np.errstate(divide="ignore", invalid="ignore"):
            p = (np.sqrt(f / self.subsampling) + 1) * self.subsampling / f
        return np.minimum(np.nan_to_num(p, nan=1.0, posinf=1.0), 1.0)

    def _encode_tokens(self):
        """Tokenize and vocab-index the whole corpus ONCE, cached across
        ``fit()`` calls for the same corpus content, tokenizer and vocab.
        Returns (flat int32 indices incl. -1 for OOV, per-sentence
        lengths)."""
        src = self.sentences if self.sentences is not None else self.iterate
        if isinstance(src, (list, tuple)):
            # content fingerprint (catches in-place corpus mutation); the
            # tokenizer's and preprocessor's identity are part of it
            sig = (id(self.vocab), id(self.tokenizer_factory),
                   id(getattr(self.tokenizer_factory, "preprocessor", None)),
                   len(src), hash(tuple(map(hash, src))))
        else:
            # non-indexable corpora (SentenceIterator-style) are streamed
            # fresh every fit: no safe identity to cache on
            sig = None
        if sig is not None and getattr(self, "_tok_cache", None) is not None \
                and self._tok_sig == sig:
            return self._tok_cache
        index_of = self.vocab.index_of
        memo = {}
        arrs = []
        for toks in self._sequences():
            a = np.empty(len(toks), np.int32)
            for k, t in enumerate(toks):
                i = memo.get(t)
                if i is None:
                    i = index_of(t)
                    memo[t] = i
                a[k] = i
            arrs.append(a)
        flat = np.concatenate(arrs) if arrs else np.zeros(0, np.int32)
        lens = np.array([len(a) for a in arrs], np.int64)
        self._tok_cache = (flat, lens)
        self._tok_sig = sig
        return self._tok_cache

    def _encode_flat(self):
        """(kept tokens, sentence ids) after per-fit subsampling: one
        vectorized bernoulli and masks over the cached token stream."""
        flat, lens = self._encode_tokens()
        if flat.size == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        rng = np.random.RandomState(self.seed + 17)
        p_keep = self._keep_probs()
        keep = (flat >= 0) & (rng.rand(flat.size)
                              < p_keep[np.maximum(flat, 0)])
        sids = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        return flat[keep], sids[keep]

    def _encode_corpus(self):
        """Corpus -> list of index arrays with per-fit subsampling (the HS /
        CBOW / GloVe / ParagraphVectors consumers; NEG skip-gram reads
        ``_encode_flat``)."""
        flat_k, sids_k = self._encode_flat()
        if flat_k.size == 0:
            return []
        bounds = np.nonzero(np.diff(sids_k))[0] + 1
        return [s for s in np.split(flat_k, bounds) if s.size > 1]

    @staticmethod
    def _flatten(seqs):
        """List of index arrays -> (flat tokens, sentence ids)."""
        flat = np.concatenate(seqs) if seqs else np.zeros(0, np.int32)
        sids = np.repeat(np.arange(len(seqs), dtype=np.int32),
                         [len(s) for s in seqs]) if seqs else \
            np.zeros(0, np.int32)
        return flat, sids

    def _make_pairs(self, seqs, rng):
        flat, sids = self._flatten(seqs)
        return self._make_pairs_flat(flat, sids, rng)

    def _make_pairs_flat(self, flat, sids, rng):
        """(center, context) pairs with the reference's randomized
        effective window (b random in [1, window] per CENTER), one numpy
        pass per window offset over the flattened corpus."""
        n = len(flat)
        if n == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        wins = rng.randint(1, self.window_size + 1, size=n)
        cs, ts = [], []
        for d in range(1, self.window_size + 1):
            if d >= n:
                break
            same = sids[:-d] == sids[d:]
            # center i, context i+d (right neighbor within i's window)
            i = np.nonzero(same & (wins[:-d] >= d))[0]
            cs.append(flat[i])
            ts.append(flat[i + d])
            # center i+d, context i (left neighbor within (i+d)'s window)
            j = np.nonzero(same & (wins[d:] >= d))[0] + d
            cs.append(flat[j])
            ts.append(flat[j - d])
        if not cs:        # corpus reduced to a single token: no pairs
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        return (np.concatenate(cs).astype(np.int32),
                np.concatenate(ts).astype(np.int32))

    def _effective_batch(self):
        """Batched scatter-adds accumulate duplicate-pair updates linearly
        where sequential SGD would damp them; cap the batch at 8x vocab so
        a small vocabulary sees few duplicates a batch."""
        return max(64, min(self.batch_size, 8 * self.vocab.num_words()))

    # ------------------------------------------------------------------- fit
    def _huffman_tables(self):
        """Padded (V, L) Huffman path tables (points, codes, mask) on the
        device for the HS paths, one row per vocab word."""
        L = max((len(w.codes) for w in self.vocab.vocab_words()), default=1)
        V = self.vocab.num_words()
        pts = np.zeros((V, L), np.int64)
        cds = np.zeros((V, L), np.float32)
        msk = np.zeros((V, L), np.float32)
        for w in self.vocab.vocab_words():
            l = len(w.codes)
            # points are inner-node ids; clip negatives (root offset) to 0..V-1
            pts[w.index, :l] = np.clip(w.points, 0, V - 1)
            cds[w.index, :l] = w.codes
            msk[w.index, :l] = 1.0
        return self._to_dev(pts), self._to_dev(cds), self._to_dev(msk)

    def _neg_pairs(self):
        """The NEG skip-gram fit's pairs, packed as the device stages them:
        center | context << 16 in one int32 when the vocabulary fits in
        15 bits, else a (2, n) stack. Returns (pairs, packed) or None when
        the corpus makes no pair."""
        rng = np.random.RandomState(self.seed + 31)
        flat_k, sids_k = self._encode_flat()
        centers, contexts = self._make_pairs_flat(flat_k, sids_k, rng)
        if len(centers) == 0:
            return None
        packed = self.vocab.num_words() < 2 ** 15
        if packed:
            return (centers.astype(np.int32)
                    | (contexts.astype(np.int32) << 16)), True
        return np.stack([centers, contexts]).astype(np.int32), False

    def fit(self):
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self._init_tables()

        if not self.use_hs and self.algorithm != "cbow":
            # NEG skip-gram: the flat corpus view, staged once and shuffled
            # on the device every epoch
            staged = self._neg_pairs()
            if staged is not None:
                pairs, packed = staged
                _sg_neg_fit(self.syn0, self.syn1, self._table,
                            self._to_dev(pairs).long(), self.learning_rate,
                            self.min_learning_rate, self._generator(),
                            self.negative, self._effective_batch(),
                            self.negative_sharing, packed, self.epochs)
            self._norm_cache = None
            return self

        rng = np.random.RandomState(self.seed + 31)
        seqs = self._encode_corpus()

        if self.algorithm == "cbow":
            # CBOW trains on (window, target) batches only (_fit_cbow
            # handles both NEG and HS objectives)
            self._fit_cbow(seqs, rng, self._generator())
            self._norm_cache = None
            return self

        pts_j, cds_j, msk_j = self._huffman_tables()
        centers_all, contexts_all = self._make_pairs(seqs, rng)
        bs = self._effective_batch()
        n_pairs = len(centers_all)
        total_steps = max(1, self.epochs * ((n_pairs + bs - 1) // bs))
        step_i = 0
        for ep in range(self.epochs):
            order = rng.permutation(n_pairs)
            for s in range(0, n_pairs, bs):
                sel = order[s:s + bs]
                lr = max(self.min_learning_rate,
                         self.learning_rate * (1.0 - step_i / total_steps))
                c = self._to_dev(centers_all[sel]).long()
                t = self._to_dev(contexts_all[sel]).long()
                _sg_hs_step(self.syn0, self.syn1, c, pts_j[t], cds_j[t],
                            msk_j[t], np.float32(lr))
                step_i += 1
        self._norm_cache = None
        return self

    def _make_cbow_windows(self, seqs, rng, with_sids=False):
        """Vectorized (contexts, mask, targets[, sequence ids]) window
        matrices: one numpy pass per offset, mirroring _make_pairs.
        ``with_sids`` also returns each kept row's sequence index
        (ParagraphVectors uses it as the document id)."""
        W = self.window_size
        flat, sids = self._flatten(seqs)
        n = len(flat)
        ctxs = np.zeros((n, 2 * W), np.int32)
        masks = np.zeros((n, 2 * W), np.float32)
        if n:
            wins = rng.randint(1, W + 1, size=n)
            for d in range(1, W + 1):
                if d >= n:
                    break
                same = sids[:-d] == sids[d:]
                # left neighbor i-d of center i -> column d-1
                li = np.nonzero(same & (wins[d:] >= d))[0] + d
                ctxs[li, d - 1] = flat[li - d]
                masks[li, d - 1] = 1.0
                # right neighbor i+d of center i -> column W+d-1
                ri = np.nonzero(same & (wins[:-d] >= d))[0]
                ctxs[ri, W + d - 1] = flat[ri + d]
                masks[ri, W + d - 1] = 1.0
        keep = masks.sum(axis=1) > 0
        out = (ctxs[keep], masks[keep], flat[keep].astype(np.int32))
        if with_sids:
            out = out + (sids[keep].astype(np.int32),)
        return out

    def _epoch_plan(self, n, bs, order, step_i, total_steps):
        """One epoch's host-side inputs, or None when the corpus yields
        nothing to train on (n == 0): (S, (S,bs) padded selection, (S,bs)
        0/1 pad weights, (S,) LR schedule). Used by the CBOW /
        ParagraphVectors paths; the NEG skip-gram fit builds the same plan
        on the device from the same ``_lr_schedule``."""
        if n == 0:
            return None
        S = (n + bs - 1) // bs
        pad = S * bs - n
        sel = np.concatenate([order, np.zeros(pad, order.dtype)])
        w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        lrs = _lr_schedule(self.learning_rate, self.min_learning_rate,
                           step_i, S, max(total_steps, 1))
        return S, sel.reshape(S, bs), w.reshape(S, bs), lrs

    def _fit_cbow(self, seqs, rng, gen):
        """CBOW pass, one epoch of (window, target) batches at a time;
        use_hierarchic_softmax selects the Huffman-path objective
        (CBOW.java:138 codes/points branch) over negative sampling."""
        ctxs, masks, targets = self._make_cbow_windows(seqs, rng)
        n = len(targets)
        bs = self._effective_batch()
        total = self.epochs * max(1, (n + bs - 1) // bs)
        step_i = 0
        if self.use_hs:
            pts_j, cds_j, msk_j = self._huffman_tables()
        for ep in range(self.epochs):
            order = np.random.RandomState(self.seed + ep).permutation(n)
            plan = self._epoch_plan(n, bs, order, step_i, total)
            if plan is None:
                return
            S, sel, w, lrs = plan
            c, m = self._to_dev(ctxs[sel]).long(), self._to_dev(masks[sel])
            t = self._to_dev(targets[sel]).long()
            w, lrs = self._to_dev(w), self._to_dev(lrs)
            if self.use_hs:
                _cbow_hs_epoch(self.syn0, self.syn1, c, m, pts_j[t],
                               cds_j[t], msk_j[t], w, lrs)
            else:
                _cbow_neg_epoch(self.syn0, self.syn1, self._table, c, m, t,
                                w, lrs, gen, self.negative)
            step_i += S

    # ------------------------------------------------------------ query API
    def word_vector(self, word) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i].cpu().numpy()

    def get_word_vector_matrix(self) -> np.ndarray:
        return self.syn0.cpu().numpy()

    def has_word(self, word) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def _normed(self):
        if self._norm_cache is None:
            m = self.get_word_vector_matrix()
            self._norm_cache = m / np.maximum(
                np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
        return self._norm_cache

    def similarity(self, w1, w2) -> float:
        i, j = self.vocab.index_of(w1), self.vocab.index_of(w2)
        if i < 0 or j < 0:
            return float("nan")
        n = self._normed()
        return float(n[i] @ n[j])

    def words_nearest(self, word, n=10) -> List[str]:
        if isinstance(word, str):
            i = self.vocab.index_of(word)
            if i < 0:
                return []
            q = self._normed()[i]
            exclude = {i}
        else:
            q = np.asarray(word, np.float64)
            q = q / max(np.linalg.norm(q), 1e-9)
            exclude = set()
        sims = self._normed() @ q
        order = np.argsort(-sims)
        out = []
        for idx in order:
            if idx in exclude:
                continue
            out.append(self.vocab.word_at_index(int(idx)))
            if len(out) >= n:
                break
        return out
