"""Synthetic token-stream pipeline for the training examples (counterpart of
``src/repro/data/pretrain.py``, host numpy, bit for bit the reference's).

Deterministic, offline: renders templated documents (the same vocabulary the
cache experiments use), tokenizes, packs into fixed-length training batches
with next-token targets.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.tokenizer import HashWordTokenizer

from .questions import QuestionPairGenerator, synthesize_response


def document_stream(seed: int = 0) -> Iterator[str]:
    gen = QuestionPairGenerator(seed=seed)
    while True:
        q = gen._random_query()
        yield q.text + " . " + synthesize_response(q.text, q.topic, q.intent)


def token_stream_batches(tokenizer: HashWordTokenizer, batch: int, seq_len: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {tokens (B,S), targets (B,S), mask (B,S)} packed batches."""
    docs = document_stream(seed)
    buf: list = []
    need = batch * (seq_len + 1)
    while True:
        while len(buf) < need:
            buf.extend(tokenizer.encode(next(docs), add_bos=True, add_eos=True))
        arr = np.asarray(buf[:need], np.int32).reshape(batch, seq_len + 1)
        buf = buf[need:]
        yield {
            "tokens": arr[:, :-1],
            "targets": arr[:, 1:],
            "mask": np.ones((batch, seq_len), np.float32),
        }
