"""Word vector persistence.

Counterpart of deeplearning4j_tpu/nlp/serializer.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference loader/WordVectorSerializer — the standard
word2vec text format ("word v1 v2 ... vD" with a "V D" header line) readable
by gensim/fastText tooling, plus a compact npz format.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class WordVectorSerializer:
    @staticmethod
    def write_word_vectors(model, path):
        """word2vec text format (parity: writeWordVectors)."""
        m = model.get_word_vector_matrix()
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{m.shape[0]} {m.shape[1]}\n")
            for i in range(m.shape[0]):
                vec = " ".join(f"{v:.6f}" for v in m[i])
                f.write(f"{model.vocab.word_at_index(i)} {vec}\n")

    @staticmethod
    def read_word_vectors(path):
        """Returns a queryable StaticWordVectors (parity: loadTxtVectors)."""
        words = []
        vecs = []
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline().split()
            V, D = int(header[0]), int(header[1])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                words.append(parts[0])
                vecs.append(np.asarray([float(x) for x in parts[1:1 + D]],
                                       np.float32))
        return StaticWordVectors(words, np.stack(vecs))

    @staticmethod
    def write_npz(model, path):
        np.savez_compressed(path, matrix=model.get_word_vector_matrix(),
                            words=np.asarray(model.vocab.words(), dtype=object))

    @staticmethod
    def read_npz(path):
        d = np.load(path, allow_pickle=True)
        return StaticWordVectors([str(w) for w in d["words"]], d["matrix"])


class StaticWordVectors:
    """Frozen lookup (parity: the WordVectors interface on loaded models)."""

    def __init__(self, words, matrix):
        self.vocab = VocabCache()
        for w in words:
            self.vocab.add_token(w, 1)
        self.matrix = matrix
        self._normed = matrix / np.maximum(
            np.linalg.norm(matrix, axis=1, keepdims=True), 1e-9)

    def word_vector(self, word):
        i = self.vocab.index_of(word)
        return None if i < 0 else self.matrix[i]

    def has_word(self, word):
        return self.vocab.contains_word(word)

    def similarity(self, w1, w2):
        i, j = self.vocab.index_of(w1), self.vocab.index_of(w2)
        if i < 0 or j < 0:
            return float("nan")
        return float(self._normed[i] @ self._normed[j])

    def words_nearest(self, word, n=10):
        i = self.vocab.index_of(word)
        if i < 0:
            return []
        sims = self._normed @ self._normed[i]
        order = np.argsort(-sims)
        return [self.vocab.word_at_index(int(k)) for k in order
                if k != i][:n]
