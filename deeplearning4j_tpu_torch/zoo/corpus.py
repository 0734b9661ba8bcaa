"""The bundled char-LM corpus as one-hot windows.

Counterpart of deeplearning4j_tpu/zoo/corpus.py: same file, same split,
same windows, so the held-out metric of the textgenlstm artifact is
computed on identical inputs in both packages.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.zoo.zoo_model import BUNDLED_DIR

CORPUS_PATH = BUNDLED_DIR / "corpus_textgen.txt"


def corpus_ids():
    """The bundled corpus as token ids (an int64 array) and its vocabulary
    string (the sorted distinct characters)."""
    text = CORPUS_PATH.read_text(encoding="utf-8")
    vocab = "".join(sorted(set(text)))
    idx = {c: i for i, c in enumerate(vocab)}
    return np.array([idx[c] for c in text], np.int64), vocab


def corpus_windows(T: int = 64, stride=None):
    """The bundled corpus as one-hot next-char windows + the vocab string.

    The last 1/8th of the TEXT is the held-out split (no window from it
    overlaps training text); training windows may overlap via ``stride``.
    Returns ``(xtr, ytr), (xte, yte), vocab`` as float32 numpy arrays."""
    ids, vocab = corpus_ids()
    eye = np.eye(len(vocab), dtype=np.float32)
    cut = (len(ids) * 7 // 8)

    def windows(a, st):
        starts = np.arange(0, len(a) - T - 1, st)
        src = np.stack([a[s:s + T] for s in starts])
        tgt = np.stack([a[s + 1:s + T + 1] for s in starts])
        return eye[src], eye[tgt]

    xtr, ytr = windows(ids[:cut], stride or T)
    xte, yte = windows(ids[cut:], T)
    return (xtr, ytr), (xte, yte), vocab
