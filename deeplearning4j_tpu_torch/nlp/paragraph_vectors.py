"""ParagraphVectors (doc2vec): PV-DBOW and PV-DM.

Counterpart of deeplearning4j_tpu/nlp/paragraph_vectors.py (parity
surface: the reference's ParagraphVectors.java, DBOW.java / DM.java,
inferVector). Batched like word2vec: PV-DBOW is skip-gram whose "center"
is the document vector; PV-DM predicts the center word from the mean of
the context words and the document vector. Host draws are the JAX
package's numpy draws; the negatives come from the model's generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec, _cbow_neg_epoch, _draw_negatives, _sg_infer_step,
    _sg_neg_epoch)


class ParagraphVectors(Word2Vec):
    """labels: one label per document (parity: LabelledDocument /
    LabelsSource). ``sentences`` = list of document strings."""

    def __init__(self, sequences_learning_algorithm="dbow", labels=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.seq_algorithm = sequences_learning_algorithm.lower()
        self.labels = labels
        self.doc_vecs = None
        self._label_index: Dict[str, int] = {}

    def _doc_labels(self, n_docs):
        if self.labels is not None:
            labels = list(self.labels)
        else:
            labels = [f"DOC_{i}" for i in range(n_docs)]
        self._label_index = {l: i for i, l in enumerate(labels)}
        return labels

    def fit(self):
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self._init_tables()
        seqs = self._encode_corpus()
        self._doc_labels(len(seqs))
        rng = np.random.RandomState(self.seed + 41)
        D = self.layer_size
        self.doc_vecs = self._to_dev(
            (rng.rand(len(seqs), D).astype(np.float32) - 0.5) / D)
        gen = self._generator(1)

        # PV-DBOW: (doc, word) pairs through the skip-gram step with the
        # doc table as syn0. PV-DM: the CBOW step with the doc vector
        # prepended to the context window (an index into [syn0; doc]).
        if self.seq_algorithm == "dbow":
            words, docs = self._flatten(seqs)
            n = len(docs)
            bs = self._effective_batch()
            total = self.epochs * max(1, (n + bs - 1) // bs)
            step_i = 0
            for ep in range(self.epochs):
                plan = self._epoch_plan(n, bs, rng.permutation(n), step_i,
                                        total)
                if plan is None:
                    break
                S, sel, w, lrs = plan
                _sg_neg_epoch(self.doc_vecs, self.syn1, self._table,
                              self._to_dev(docs[sel]).long(),
                              self._to_dev(words[sel]).long(),
                              self._to_dev(w), self._to_dev(lrs), gen,
                              self.negative)
                step_i += S
            # also train word vectors (reference trainWordVectors=true default)
            super().fit()
        else:  # dm
            V = self.vocab.num_words()
            # windows with the sequence id as the document id, then a
            # doc-vector slot prepended (an index into [syn0; doc_vecs])
            ctxs_w, masks_w, targets, sids = self._make_cbow_windows(
                seqs, rng, with_sids=True)
            ctxs = np.concatenate([(V + sids)[:, None], ctxs_w], axis=1)
            masks = np.concatenate(
                [np.ones((len(sids), 1), np.float32), masks_w], axis=1)
            combined = torch.cat([self.syn0, self.doc_vecs], dim=0)
            n = len(targets)
            bs = self._effective_batch()
            total = self.epochs * max(1, (n + bs - 1) // bs)
            step_i = 0
            for ep in range(self.epochs):
                plan = self._epoch_plan(n, bs, rng.permutation(n), step_i,
                                        total)
                if plan is None:
                    break
                S, sel, w, lrs = plan
                _cbow_neg_epoch(combined, self.syn1, self._table,
                                self._to_dev(ctxs[sel]).long(),
                                self._to_dev(masks[sel]),
                                self._to_dev(targets[sel]).long(),
                                self._to_dev(w), self._to_dev(lrs), gen,
                                self.negative)
                step_i += S
            self.syn0 = combined[:V]
            self.doc_vecs = combined[V:]
        self._norm_cache = None
        return self

    # ------------------------------------------------------------ query API
    def doc_vector(self, label) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        return None if i is None else self.doc_vecs[i].cpu().numpy()

    def infer_vector(self, text, steps: int = 20, lr: float = 0.05):
        """Infer a vector for unseen text: gradient steps on a fresh doc
        vector with frozen word/context tables (parity: inferVector)."""
        toks = self.tokenizer_factory.create(text).get_tokens()
        idx = [self.vocab.index_of(t) for t in toks]
        idx = np.asarray([i for i in idx if i >= 0], np.int64)
        if len(idx) == 0:
            return np.zeros(self.layer_size, np.float32)
        rng = np.random.RandomState(self.seed + 97)
        dv = self._to_dev((rng.rand(1, self.layer_size).astype(np.float32)
                           - 0.5) / self.layer_size)
        gen = self._generator(5)
        docs = torch.zeros(len(idx), dtype=torch.long, device=self.device)
        words = self._to_dev(idx)
        for s in range(steps):
            draw = _draw_negatives(gen, (len(idx), self.negative),
                                   self._table.shape[0], self.device)
            _sg_infer_step(dv, self.syn1, self._table, docs, words,
                           np.float32(lr * (1 - s / steps) + 1e-4), draw)
        return dv[0].cpu().numpy()

    def nearest_labels(self, text_or_vec, n=5) -> List[str]:
        if isinstance(text_or_vec, str):
            q = self.infer_vector(text_or_vec)
        else:
            q = np.asarray(text_or_vec)
        q = q / max(np.linalg.norm(q), 1e-9)
        m = self.doc_vecs.cpu().numpy()
        m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
        sims = m @ q
        order = np.argsort(-sims)[:n]
        inv = {v: k for k, v in self._label_index.items()}
        return [inv[int(i)] for i in order]
