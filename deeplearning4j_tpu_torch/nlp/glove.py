"""GloVe embeddings.

Counterpart of deeplearning4j_tpu/nlp/glove.py (parity surface: the
reference's Glove.java and AbstractCoOccurrences): co-occurrence counting
over a window with 1/d weighting on the host, then AdaGrad on the
weighted least-squares objective f(X_ij)(w_i.w~_j + b_i + b~_j -
log X_ij)^2 as batches of (i, j, X_ij) triples on the device, with the
JAX package's numpy draws, so both packages train on the same batches.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, _scatter_add


def _glove_step(w, wc, b, bc, gw, gwc, gb, gbc, ii, jj, logx, fx, lr):
    """AdaGrad batch on the GloVe objective, in place: the accumulators
    first, then each table's step over its updated accumulator rows."""
    wi = w[ii]
    wj = wc[jj]
    diff = (wi * wj).sum(-1) + b[ii] + bc[jj] - logx     # (B,)
    fdiff = fx * diff
    gi = fdiff[:, None] * wj
    gj = fdiff[:, None] * wi
    _scatter_add(gw, ii, gi ** 2)
    _scatter_add(gwc, jj, gj ** 2)
    _scatter_add(gb, ii, fdiff ** 2)
    _scatter_add(gbc, jj, fdiff ** 2)
    _scatter_add(w, ii, -lr * gi / torch.sqrt(gw[ii] + 1e-8))
    _scatter_add(wc, jj, -lr * gj / torch.sqrt(gwc[jj] + 1e-8))
    _scatter_add(b, ii, -lr * fdiff / torch.sqrt(gb[ii] + 1e-8))
    _scatter_add(bc, jj, -lr * fdiff / torch.sqrt(gbc[jj] + 1e-8))


class Glove(Word2Vec):
    def __init__(self, x_max=100.0, alpha=0.75, learning_rate=0.05, epochs=5,
                 symmetric=True, **kwargs):
        kwargs.setdefault("batch_size", 4096)
        super().__init__(learning_rate=learning_rate, epochs=epochs, **kwargs)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric

    def _cooccurrences(self, seqs):
        counts = defaultdict(float)
        for seq in seqs:
            n = len(seq)
            for i in range(n):
                for j in range(max(0, i - self.window_size), i):
                    d = i - j
                    counts[(int(seq[i]), int(seq[j]))] += 1.0 / d
                    if self.symmetric:
                        counts[(int(seq[j]), int(seq[i]))] += 1.0 / d
        ii = np.fromiter((k[0] for k in counts), np.int32, len(counts))
        jj = np.fromiter((k[1] for k in counts), np.int32, len(counts))
        xx = np.fromiter(counts.values(), np.float32, len(counts))
        return ii, jj, xx

    def fit(self):
        if self.vocab is None:
            self.build_vocab()
        seqs = self._encode_corpus()
        ii, jj, xx = self._cooccurrences(seqs)
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.RandomState(self.seed)
        w = self._to_dev((rng.rand(V, D).astype(np.float32) - 0.5) / D)
        wc = self._to_dev((rng.rand(V, D).astype(np.float32) - 0.5) / D)
        dev = self.device
        b = torch.zeros(V, device=dev)
        bc = torch.zeros(V, device=dev)
        gw = torch.full((V, D), 1e-8, device=dev)
        gwc = torch.full((V, D), 1e-8, device=dev)
        gb = torch.full((V,), 1e-8, device=dev)
        gbc = torch.full((V,), 1e-8, device=dev)

        logx = np.log(np.maximum(xx, 1e-10))
        fx = np.minimum((xx / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        ii_d, jj_d = self._to_dev(ii).long(), self._to_dev(jj).long()
        logx_d, fx_d = self._to_dev(logx), self._to_dev(fx)
        n = len(ii)
        bs = self._effective_batch()
        for ep in range(self.epochs):
            order = self._to_dev(rng.permutation(n))
            for s in range(0, n, bs):
                sel = order[s:s + bs]
                _glove_step(w, wc, b, bc, gw, gwc, gb, gbc, ii_d[sel],
                            jj_d[sel], logx_d[sel], fx_d[sel],
                            self.learning_rate)
        self.syn0 = w + wc  # standard GloVe: sum of both tables
        self.syn1 = wc
        self._norm_cache = None
        return self
