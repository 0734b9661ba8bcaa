"""Tokenization.

Counterpart of deeplearning4j_tpu/nlp/tokenization.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference text/tokenization/ — TokenizerFactory SPI,
DefaultTokenizerFactory (whitespace+punct), NGramTokenizerFactory,
preprocessors (CommonPreprocessor lowercases + strips punctuation).
"""

from __future__ import annotations

import re
from typing import List, Optional, Callable


class CommonPreprocessor:
    """Lowercase + strip punctuation (parity: CommonPreprocessor).

    Results are memoized per distinct raw token: a natural-language corpus
    repeats its vocabulary constantly (Zipf), so after warm-up each token
    costs one dict hit instead of a regex pass — this is the difference
    between tokenization dominating Word2Vec wall time and vanishing into
    it. Memory is O(distinct tokens), the same order as the vocab itself."""

    _PUNCT = re.compile(r"[^\w\s]|_", re.UNICODE)

    def __init__(self):
        self._memo = {}

    def pre_process(self, token: str) -> str:
        r = self._memo.get(token)
        if r is None:
            r = self._PUNCT.sub("", token.lower())
            self._memo[token] = r
        return r


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)


class DefaultTokenizerFactory:
    """Whitespace tokenizer with optional preprocessor
    (parity: DefaultTokenizerFactory)."""

    def __init__(self):
        self._pre: Optional[Callable] = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self._pre is not None:
            toks = [self._pre.pre_process(t) for t in toks]
            toks = [t for t in toks if t]
        return Tokenizer(toks)


_CJK_RANGES = (
    (0x4E00, 0x9FFF),      # CJK Unified Ideographs
    (0x3400, 0x4DBF),      # CJK Extension A
    (0xF900, 0xFAFF),      # CJK Compatibility Ideographs
    (0x3040, 0x30FF),      # Hiragana + Katakana
    (0xAC00, 0xD7AF),      # Hangul syllables
)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


class CJKTokenizerFactory:
    """Tokenizer for unsegmented CJK text behind the same SPI
    (parity role: the reference's deeplearning4j-nlp-chinese/-japanese/
    -korean tokenizer modules — those wrap dictionary segmenters; this
    implements the dictionary-free character-bigram scheme standard in CJK
    information retrieval).

    Mixed text is handled: runs of CJK codepoints emit overlapping bigrams
    (single-char runs emit the char), non-CJK spans fall back to the base
    whitespace tokenizer, so "我爱机器学习 and jax" → 我爱, 爱机, 机器, 器学,
    学习, and, jax."""

    def __init__(self, bigrams: bool = True):
        self.bigrams = bigrams
        self._pre: Optional[Callable] = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def _segment(self, text: str) -> List[str]:
        out: List[str] = []
        latin: List[str] = []
        run: List[str] = []

        def flush_latin():
            if latin:
                for t in "".join(latin).split():
                    out.append(t)
                latin.clear()

        def flush_run():
            if run:
                if len(run) == 1 or not self.bigrams:
                    out.extend(run)
                else:
                    out.extend(run[i] + run[i + 1]
                               for i in range(len(run) - 1))
                run.clear()

        for ch in text:
            if _is_cjk(ch):
                flush_latin()
                run.append(ch)
            else:
                flush_run()
                latin.append(ch)
        flush_latin()
        flush_run()
        return out

    def create(self, text: str) -> Tokenizer:
        toks = self._segment(text)
        if self._pre is not None:
            toks = [self._pre.pre_process(t) for t in toks]
            toks = [t for t in toks if t]
        return Tokenizer(toks)


class NGramTokenizerFactory:
    """Word n-grams over a base tokenizer (parity: NGramTokenizerFactory)."""

    def __init__(self, base_factory, min_n: int, max_n: int):
        self.base = base_factory
        self.min_n = min_n
        self.max_n = max_n

    def set_token_pre_processor(self, pre):
        self.base.set_token_pre_processor(pre)
        return self

    def create(self, text: str) -> Tokenizer:
        words = self.base.create(text).get_tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                out.append(" ".join(words[i:i + n]))
        return Tokenizer(out)
