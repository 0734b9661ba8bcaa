"""Dictionary-driven CJK word segmentation behind the TokenizerFactory SPI.

Counterpart of deeplearning4j_tpu/nlp/segmenters.py: the same host code,
name for name (it runs nothing on a device).

Parity role: the reference ships whole modules wrapping dictionary
segmenters for unsegmented scripts (deeplearning4j-nlp-chinese/ wraps a
Chinese lexicon analyzer, deeplearning4j-nlp-japanese/ bundles Kuromoji's
dictionary pipeline, deeplearning4j-nlp-korean/ wraps a Korean morpheme
analyzer). This module is this repo's equivalent: a self-contained
bidirectional maximal-matching segmenter (the classic MMSEG-family
algorithm those analyzers build on) over a bundled lexicon, exposed
through the same ``TokenizerFactory`` SPI as every other tokenizer — so
Word2Vec / ParagraphVectors / CnnSentence consume real CJK words, not
characters, with zero external dependencies.

Algorithm (bidirectional maximal matching, standard in CJK IR):
- forward pass: at each position greedily take the LONGEST lexicon word
  (unknown characters fall back to single-char tokens);
- backward pass: same from the right;
- disambiguation: prefer the pass with fewer words; tie → fewer
  single-character tokens; tie → backward (empirically better for Chinese
  — the convention the MMSEG literature uses).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, List, Optional

from deeplearning4j_tpu_torch.nlp.tokenization import Tokenizer, _is_cjk

_DATA_DIR = Path(__file__).parent / "data"
_BUNDLED = {"zh": _DATA_DIR / "cjk_lexicon_zh.txt",
            "ja": _DATA_DIR / "cjk_lexicon_ja.txt"}


def load_bundled_lexicon(lang: str) -> List[str]:
    """Words of the bundled lexicon for ``lang`` ('zh' | 'ja')."""
    p = _BUNDLED[lang]
    return [w for w in p.read_text(encoding="utf-8").split()
            if w and not w.startswith("#")]


class MaxMatchSegmenter:
    """Bidirectional maximal matching over a word list."""

    def __init__(self, lexicon: Iterable[str]):
        self.words = set(lexicon)
        self.max_len = max((len(w) for w in self.words), default=1)

    def _greedy(self, text: str, reverse: bool) -> List[str]:
        out: List[str] = []
        if reverse:
            i = len(text)
            while i > 0:
                for l in range(min(self.max_len, i), 0, -1):
                    if l == 1 or text[i - l:i] in self.words:
                        out.append(text[i - l:i])
                        i -= l
                        break
            out.reverse()
        else:
            i = 0
            while i < len(text):
                for l in range(min(self.max_len, len(text) - i), 0, -1):
                    if l == 1 or text[i:i + l] in self.words:
                        out.append(text[i:i + l])
                        i += l
                        break
        return out

    def segment(self, text: str) -> List[str]:
        fwd = self._greedy(text, reverse=False)
        bwd = self._greedy(text, reverse=True)
        if len(fwd) != len(bwd):
            return fwd if len(fwd) < len(bwd) else bwd
        singles_f = sum(1 for w in fwd if len(w) == 1)
        singles_b = sum(1 for w in bwd if len(w) == 1)
        return fwd if singles_f < singles_b else bwd


class DictionarySegmenterTokenizerFactory:
    """TokenizerFactory whose CJK spans go through MaxMatchSegmenter.

    Drop-in at the same seam as DefaultTokenizerFactory /
    CJKTokenizerFactory: mixed text keeps whitespace semantics for
    non-CJK spans; runs of CJK codepoints are segmented into lexicon
    words. ``lexicon`` may be a language key ('zh' | 'ja') for the
    bundled lists, or any iterable of words (the reference's analyzers
    are likewise dictionary-swappable)."""

    def __init__(self, lexicon="zh"):
        words = (load_bundled_lexicon(lexicon) if isinstance(lexicon, str)
                 else list(lexicon))
        self.segmenter = MaxMatchSegmenter(words)
        self._pre: Optional[Callable] = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def _tokens(self, text: str) -> List[str]:
        out: List[str] = []
        latin: List[str] = []
        run: List[str] = []

        def flush_latin():
            if latin:
                out.extend("".join(latin).split())
                latin.clear()

        def flush_run():
            if run:
                out.extend(self.segmenter.segment("".join(run)))
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
        toks = self._tokens(text)
        if self._pre is not None:
            toks = [self._pre.pre_process(t) for t in toks]
            toks = [t for t in toks if t]
        return Tokenizer(toks)
