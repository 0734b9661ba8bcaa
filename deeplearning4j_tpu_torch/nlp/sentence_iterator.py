"""Sentence iterators.

Counterpart of deeplearning4j_tpu/nlp/sentence_iterator.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference text/sentenceiterator/ — SentenceIterator SPI,
CollectionSentenceIterator, BasicLineIterator (file lines),
FileSentenceIterator (directory of files), sentence preprocessors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Callable


class SentenceIterator:
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> str:
        raise NotImplementedError

    def reset(self):
        pass

    def set_pre_processor(self, fn: Callable[[str], str]):
        self._pre = fn
        return self

    def _apply_pre(self, s: str) -> str:
        pre = getattr(self, "_pre", None)
        return pre(s) if pre else s


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self.sentences = list(sentences)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self.sentences):
            raise StopIteration
        s = self.sentences[self._pos]
        self._pos += 1
        return self._apply_pre(s)


class BasicLineIterator(SentenceIterator):
    """One sentence per file line (parity: BasicLineIterator)."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def reset(self):
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8")

    def __next__(self):
        if self._fh is None:
            self.reset()
        line = self._fh.readline()
        if not line:
            self._fh.close()
            self._fh = None
            raise StopIteration
        return self._apply_pre(line.rstrip("\n"))


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory (parity: FileSentenceIterator)."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self._files: List[Path] = []
        self._idx = 0
        self._inner: Optional[BasicLineIterator] = None

    def reset(self):
        self._files = sorted(p for p in self.dir.rglob("*") if p.is_file())
        self._idx = 0
        self._inner = None

    def __next__(self):
        if not self._files:
            self.reset()
        while True:
            if self._inner is None:
                if self._idx >= len(self._files):
                    raise StopIteration
                self._inner = BasicLineIterator(self._files[self._idx])
                self._inner.reset()
                self._idx += 1
            try:
                return self._apply_pre(next(self._inner))
            except StopIteration:
                self._inner = None
