"""Frozen copy of ``repro_torch/tokenizer/tokenizer.py``: the reference's own
tokenizer.  Deterministic offline tokenizer.

Word-level hashing tokenizer: lowercased word/punct pieces map to stable ids
via blake2, so identical words always share an id across runs and processes
(a requirement for the semantic-cache experiments — paraphrases must share
token statistics).  No external vocab files; fully offline.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = {"pad": 0, "bos": 1, "eos": 2, "sep": 3, "unk": 4}
NUM_SPECIAL = len(SPECIAL_TOKENS)
_WORD_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")


class HashWordTokenizer:
    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > NUM_SPECIAL + 16
        self.vocab_size = vocab_size
        self.pad = SPECIAL_TOKENS["pad"]
        self.bos = SPECIAL_TOKENS["bos"]
        self.eos = SPECIAL_TOKENS["eos"]
        self.sep = SPECIAL_TOKENS["sep"]

    def _word_id(self, w: str) -> int:
        h = hashlib.blake2s(w.encode("utf-8"), digest_size=8).digest()
        return NUM_SPECIAL + int.from_bytes(h, "little") % (self.vocab_size - NUM_SPECIAL)

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        ids = [self.bos] if add_bos else []
        ids += [self._word_id(w) for w in _WORD_RE.findall(text.lower())]
        if add_eos:
            ids.append(self.eos)
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     add_bos: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (B, max_len) int32, mask (B, max_len) float32)."""
        b = len(texts)
        toks = np.full((b, max_len), self.pad, np.int32)
        mask = np.zeros((b, max_len), np.float32)
        for i, t in enumerate(texts):
            ids = self.encode(t, add_bos=add_bos)[:max_len]
            toks[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1.0
        return toks, mask

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Hash tokenizer is lossy; emit stable placeholder words for ids."""
        out = []
        inv = {v: k for k, v in SPECIAL_TOKENS.items()}
        for i in ids:
            out.append(f"<{inv[i]}>" if i in inv else f"w{i}")
        return " ".join(out)
