"""Vocabulary construction + Huffman coding.

Counterpart of deeplearning4j_tpu/nlp/vocab.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference models/word2vec/wordstore/ — VocabWord,
AbstractCache (VocabCache), VocabConstructor (corpus scan with
minWordFrequency filtering), and the Huffman tree used for hierarchical
softmax (models/word2vec/Huffman.java; also graph GraphHuffman.java).
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class VocabWord:
    word: str
    count: int = 0
    index: int = -1
    # hierarchical-softmax Huffman data
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)


class VocabCache:
    """In-memory vocab (parity: wordstore/inmemory/AbstractCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word, count=0, index=len(self._by_index))
            self._words[word] = vw
            self._by_index.append(vw)
        vw.count += count
        self.total_word_count += count

    def contains_word(self, word) -> bool:
        return word in self._words

    def word_for(self, word) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, idx) -> str:
        return self._by_index[idx].word

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def word_frequency(self, word) -> int:
        vw = self._words.get(word)
        return 0 if vw is None else vw.count

    def truncate(self, min_count: int):
        """Drop rare words and reindex (parity: minWordFrequency filter)."""
        kept = [w for w in self._by_index if w.count >= min_count]
        kept.sort(key=lambda w: -w.count)
        self._words = {}
        self._by_index = []
        self.total_word_count = 0
        for w in kept:
            w.index = len(self._by_index)
            self._words[w.word] = w
            self._by_index.append(w)
            self.total_word_count += w.count


class VocabConstructor:
    """Corpus scanner (parity: VocabConstructor; SequenceVectors.buildVocab
    :108 path)."""

    def __init__(self, min_word_frequency: int = 5):
        self.min_word_frequency = min_word_frequency

    def build_vocab(self, sequences) -> VocabCache:
        """sequences: iterable of token lists."""
        counts = Counter()
        for seq in sequences:
            counts.update(seq)
        vocab = VocabCache()
        for w, c in counts.most_common():
            if c >= self.min_word_frequency:
                vocab.add_token(w, c)
        return vocab


def build_huffman(vocab: VocabCache, max_code_length: int = 40):
    """Assign Huffman codes/points to every vocab word (parity:
    models/word2vec/Huffman.java). points = inner-node indices root→leaf,
    codes = 0/1 branch decisions."""
    n = vocab.num_words()
    if n == 0:
        return
    heap = [(w.count, w.index, w.index, None, None) for w in vocab.vocab_words()]
    # entries: (count, tiebreak, node_id, left, right); leaves are node_id < n
    heapq.heapify(heap)
    next_id = n
    nodes = {}
    while len(heap) > 1:
        c1, _, id1, l1, r1 = heapq.heappop(heap)
        c2, _, id2, l2, r2 = heapq.heappop(heap)
        nodes[next_id] = (id1, id2)
        heapq.heappush(heap, (c1 + c2, next_id, next_id, id1, id2))
        next_id += 1
    root = heap[0][2]

    # walk the tree assigning codes
    stack = [(root, [], [])]
    while stack:
        node, code, points = stack.pop()
        if node < n:  # leaf
            vw = vocab._by_index[node]
            vw.codes = code[:max_code_length]
            # inner-node index relative (node_id - n) like word2vec's layout
            vw.points = [p - n for p in points][:max_code_length]
            continue
        left, right = nodes[node]
        stack.append((left, code + [0], points + [node]))
        stack.append((right, code + [1], points + [node]))


def unigram_table(vocab: VocabCache, power: float = 0.75,
                  table_size: int = 1 << 20) -> np.ndarray:
    """Negative-sampling distribution table (parity: word2vec's unigram
    table; sampled with one randint per draw on device)."""
    counts = np.array([w.count for w in vocab.vocab_words()], np.float64)
    probs = counts ** power
    probs /= probs.sum()
    return np.repeat(np.arange(len(probs)),
                     np.maximum((probs * table_size).astype(np.int64), 1))
