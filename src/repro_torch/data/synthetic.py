"""Synthetic corpus generator (the port's copy of `repro.data.synthetic`):
Zipfian token streams with repeated documents (to exercise dedup) and a
learnable bigram structure."""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng, n, vocab, alpha=1.1):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs).astype(np.int32)


def bigram_doc(rng, length, vocab, order=64):
    """Deterministic bigram chain: token t+1 = (a*t + b) % vocab with noise --
    learnable structure for the quickstart trainer."""
    a = 6364136223846793005 % vocab | 1
    b = 1442695040888963407 % vocab
    out = np.empty(length, np.int32)
    out[0] = rng.integers(vocab)
    noise = rng.random(length) < 0.1
    for i in range(1, length):
        out[i] = rng.integers(vocab) if noise[i] else (a * int(out[i - 1]) + b) % vocab
    return out


def corpus(seed: int, n_docs: int, vocab: int, doc_len=(64, 512), dup_rate=0.1):
    """Yield documents; ~dup_rate of them are exact repeats of earlier docs."""
    rng = np.random.default_rng(seed)
    history = []
    for _ in range(n_docs):
        if history and rng.random() < dup_rate:
            yield history[rng.integers(len(history))]
            continue
        L = int(rng.integers(doc_len[0], doc_len[1]))
        doc = bigram_doc(rng, L, vocab)
        if len(history) < 256:
            history.append(doc)
        yield doc
