"""CnnSentenceDataSetIterator — sentences + word vectors → CNN inputs.

Counterpart of deeplearning4j_tpu/nlp/cnn_sentence_iterator.py: the same
host code, name for name (it runs nothing on a device).

Parity surface: reference deeplearning4j-nlp/.../iterator/
CnnSentenceDataSetIterator.java: tokenizes labeled sentences, looks up each
token's embedding, and emits image-shaped batches for sentence-classification
CNNs (Kim 2014), with a per-timestep feature mask for variable lengths and
UnknownWordHandling (RemoveWord | UseUnknownVector).

Layout: the reference emits NCHW (B, 1, maxLen, vecSize) ('sentences along
height'); this framework is NHWC-native, so features are
(B, maxLen, vecSize, 1) — same tensor, the port's channels-last order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class UnknownWordHandling:
    REMOVE_WORD = "remove_word"
    USE_UNKNOWN_VECTOR = "use_unknown_vector"


class CnnSentenceDataSetIterator(DataSetIterator):
    """``sentence_provider``: iterable of (sentence, label) pairs.
    ``word_vectors``: any object with has_word(w), word_vector(w) and a
    vector size (Word2Vec/ParagraphVectors/loaded serializer vectors)."""

    _MISS = object()

    def __init__(self, sentence_provider: Sequence[Tuple[str, str]],
                 word_vectors, batch_size: int = 32,
                 max_sentence_length: int = 64,
                 unknown_word_handling: str = UnknownWordHandling.REMOVE_WORD,
                 tokenizer_factory=None, labels: Optional[List[str]] = None,
                 use_normalized_word_vectors: bool = False):
        self.data = list(sentence_provider)
        self.word_vectors = word_vectors
        self.batch_size = batch_size
        self.max_sentence_length = max_sentence_length
        self.unknown_word_handling = unknown_word_handling
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.labels = labels or sorted({lab for _, lab in self.data})
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self.use_normalized = use_normalized_word_vectors
        probe = next((w for s, _ in self.data
                      for w in self.tokenizer_factory.create(s).get_tokens()
                      if word_vectors.has_word(w)), None)
        if probe is None:
            raise ValueError("no sentence token is in the word-vector vocab")
        self.word_vector_size = int(
            np.asarray(word_vectors.word_vector(probe)).shape[-1])
        self._unknown = np.zeros(self.word_vector_size, np.float32)
        self._vec_cache = {}
        self._pos = 0

    # ------------------------------------------------------------ encoding
    def _vector(self, w):
        # cache host-side: word_vector() on a device-backed table is a
        # device->host copy per call
        v = self._vec_cache.get(w, self._MISS)
        if v is self._MISS:
            if self.word_vectors.has_word(w):
                v = np.asarray(self.word_vectors.word_vector(w), np.float32)
                if self.use_normalized:
                    v = v / max(float(np.linalg.norm(v)), 1e-9)
            elif (self.unknown_word_handling
                    == UnknownWordHandling.USE_UNKNOWN_VECTOR):
                v = self._unknown
            else:
                v = None                               # RemoveWord
            self._vec_cache[w] = v
        return v

    def _tokens(self, sentence):
        toks = self.tokenizer_factory.create(sentence).get_tokens()
        vecs = [self._vector(t) for t in toks]
        return [v for v in vecs if v is not None][:self.max_sentence_length]

    def load_single_sentence(self, sentence: str) -> np.ndarray:
        """(1, L, vecSize, 1) features for inference on one sentence
        (parity: loadSingleSentence)."""
        vecs = self._tokens(sentence)
        if not vecs:
            raise ValueError("sentence has no known words")
        arr = np.stack(vecs)[None, :, :, None]
        return arr.astype(np.float32)

    # ------------------------------------------------------------ iterator
    def reset(self):
        self._pos = 0

    def __next__(self) -> DataSet:
        encoded = []
        while not encoded:                 # skip all-unknown batches (loop,
            if self._pos >= len(self.data):   # not recursion: OOV-heavy data
                raise StopIteration           # would blow the stack)
            batch = self.data[self._pos:self._pos + self.batch_size]
            self._pos += len(batch)
            for sent, lab in batch:
                vecs = self._tokens(sent)
                if vecs:
                    encoded.append((vecs, lab))
        L = max(len(v) for v, _ in encoded)
        B = len(encoded)
        feats = np.zeros((B, L, self.word_vector_size, 1), np.float32)
        fmask = np.zeros((B, L), np.float32)
        labels = np.zeros((B, len(self.labels)), np.float32)
        for i, (vecs, lab) in enumerate(encoded):
            feats[i, :len(vecs), :, 0] = np.stack(vecs)
            fmask[i, :len(vecs)] = 1.0
            labels[i, self._label_idx[lab]] = 1.0
        return DataSet(feats, labels, features_mask=fmask)

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return len(self.labels)
