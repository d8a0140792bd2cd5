"""Request batching: pad-to-bucket grouping so jit re-compiles are bounded.

The TweakLLM engine splits each incoming batch into MISS / TWEAK / EXACT
sub-batches with different prompt shapes; the batcher pads each sub-batch to
the nearest (batch, length) bucket so the number of compiled specializations
stays small under production traffic.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
LEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def bucket_batch(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def bucket_len(n: int) -> int:
    for b in LEN_BUCKETS:
        if n <= b:
            return b
    return ((n + LEN_BUCKETS[-1] - 1) // LEN_BUCKETS[-1]) * LEN_BUCKETS[-1]


def floor_len_bucket(n: int) -> int:
    """Largest length bucket <= n (n itself below the smallest bucket).

    Clamping an encode budget to this guarantees ``pad_to_buckets`` cannot
    round the row length back ABOVE the budget — buckets are fixed points
    of ``bucket_len``.  Callers with n below the smallest bucket must
    bound-check ``bucket_len(n)`` themselves.
    """
    if n < LEN_BUCKETS[0]:
        return n
    if n >= LEN_BUCKETS[-1]:
        return (n // LEN_BUCKETS[-1]) * LEN_BUCKETS[-1]
    best = LEN_BUCKETS[0]
    for b in LEN_BUCKETS:
        if b <= n:
            best = b
    return best


def pad_to_buckets(tokens: np.ndarray, mask: np.ndarray,
                   pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad (B, L) token/mask arrays up to bucket sizes.  Returns real B."""
    b, l = tokens.shape
    bb, lb = bucket_batch(b), bucket_len(l)
    out_t = np.full((bb, lb), pad_id, tokens.dtype)
    out_m = np.zeros((bb, lb), mask.dtype)
    out_t[:b, :l] = tokens
    out_m[:b, :l] = mask
    if bb > b:  # pad rows must still be valid model input: repeat row 0
        out_t[b:] = out_t[0]
        out_m[b:] = out_m[0]
    return out_t, out_m, b
