"""The token inputs the serving path feeds its two models, worked out again
by the reference: a frozen copy of the prompt layout of
``repro_torch/core/tweak.py`` (the paper's Appendix-A TWEAK prompt) and of
the bucket rules of ``repro_torch/serving/batcher.py``.

The check builds every MISS and TWEAK prompt of a sampled dispatch from the
request texts and the cached pair it was routed to, and requires the
tokens the program fed its generators to equal these, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .tokenizer import HashWordTokenizer

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
LEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)

TWEAK_INSTRUCTION = (
    "you are part of a caching architecture . tailor the cached response to "
    "the current user prompt for relevance accuracy precision and clarity . "
    "do not reference the cached question . reflect the nuances and intent "
    "of the new prompt .")
QUERY_SUFFIX = " answer briefly"
STATIC, CACHED_QUERY, CACHED_RESPONSE, NEW_QUERY = ("static", "cached_query",
                                                    "cached_response", "new_query")
SEGMENTS = (
    (STATIC, TWEAK_INSTRUCTION + " cached prompt :"),
    (CACHED_QUERY, ""),
    (STATIC, ". cached response :"),
    (CACHED_RESPONSE, ""),
    (STATIC, ". user's current prompt :"),
    (NEW_QUERY, ""),
    (STATIC, ". adapted response :"),
)
TRUNCATE_ORDER = (CACHED_RESPONSE, CACHED_QUERY, NEW_QUERY)


def bucket_batch(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def bucket_len(n: int) -> int:
    for b in LEN_BUCKETS:
        if n <= b:
            return b
    return -(-n // LEN_BUCKETS[-1]) * LEN_BUCKETS[-1]


def floor_len_bucket(n: int) -> int:
    if n < LEN_BUCKETS[0]:
        return n
    if n >= LEN_BUCKETS[-1]:
        return (n // LEN_BUCKETS[-1]) * LEN_BUCKETS[-1]
    return max(b for b in LEN_BUCKETS if b <= n)


def pad_rows(rows: Sequence[List[int]], length: int, pad: int = 0) -> np.ndarray:
    """Rows to a (bucket_batch(n), length) matrix; padding rows repeat row 0,
    as the serving path pads a batch."""
    out = np.full((bucket_batch(len(rows)), length), pad, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    out[len(rows):] = out[0]
    return out


def preprocess(text: str) -> str:
    return text.strip() + QUERY_SUFFIX


def prefix_ids(tok: HashWordTokenizer) -> List[int]:
    return tok.encode(SEGMENTS[0][1], add_bos=True)


def _static_tokens(tok: HashWordTokenizer, suffix_only: bool) -> int:
    n, first = 0, not suffix_only
    for kind, text in (SEGMENTS[1:] if suffix_only else SEGMENTS):
        if kind == STATIC:
            n += len(tok.encode(text, add_bos=first))
            first = False
    return n


def tweak_row(tok: HashWordTokenizer, new_q: str, cached_q: str, cached_r: str,
              max_len: int, drop_prefix: bool) -> List[int]:
    """One Appendix-A prompt (its suffix when ``drop_prefix``), the cached
    response trimmed first, then the cached query, then the new query."""
    vals = {CACHED_QUERY: cached_q, CACHED_RESPONSE: cached_r, NEW_QUERY: new_q}
    segs = [(k, vals.get(k, t)) for k, t in SEGMENTS]
    if drop_prefix:
        segs = segs[1:]
    ids = [(k, tok.encode(t, add_bos=(not drop_prefix) and i == 0))
           for i, (k, t) in enumerate(segs)]
    over = sum(len(x) for _, x in ids) - max_len
    keep = {k: len(x) for k, x in ids if k != STATIC}
    for field in TRUNCATE_ORDER:
        take = min(keep.get(field, 0), max(over, 0))
        keep[field] = keep.get(field, 0) - take
        over -= take
    if over > 0:
        raise ValueError("the static segments alone exceed the prompt budget")
    return [t for k, x in ids for t in (x if k == STATIC else x[:keep[k]])]


def tweak_budget(tok: HashWordTokenizer, max_seq_len: int, max_new: int,
                 prefix_len: int) -> int:
    """The prompt (or suffix) budget the serving path encodes to: the model's
    context less the budget, rounded down to a length bucket when the
    bucket of the remainder would not fit (``core/engine.py``)."""
    budget = max_seq_len - max_new - 1 - prefix_len
    if bucket_len(budget) + prefix_len + max_new + 1 > max_seq_len:
        budget = floor_len_bucket(budget)
    if budget < _static_tokens(tok, suffix_only=prefix_len > 0):
        raise ValueError("no TWEAK prompt fits the small model's context")
    return budget


def tweak_calls(tok: HashWordTokenizer, rows: List[Tuple[str, str, str]], max_seq_len: int,
                max_new: int, prefixed: bool) -> List[Dict]:
    """The small model's generate calls of one dispatch's TWEAK rows, in
    the order the serving path makes them: ``rows`` are (new query, cached
    query, cached response), preprocessed.  With the prefix path, one call
    per length bucket of the real suffix (rows in their order within it);
    without, one call over the full prompts padded to the budget."""
    pre = prefix_ids(tok) if prefixed else []
    budget = tweak_budget(tok, max_seq_len, max_new, len(pre))
    enc = [tweak_row(tok, n, c, r, budget, drop_prefix=prefixed) for n, c, r in rows]
    if not prefixed:
        return [{"rows": list(range(len(rows))), "tokens": pad_rows(enc, bucket_len(budget)),
                 "prefix": []}]
    groups: Dict[int, List[int]] = {}
    for i, e in enumerate(enc):
        groups.setdefault(bucket_len(max(len(e), 1)), []).append(i)
    return [{"rows": groups[b], "tokens": pad_rows([enc[i] for i in groups[b]], b),
             "prefix": pre} for b in sorted(groups)]


def miss_call(tok: HashWordTokenizer, queries: List[str], max_query_len: int) -> Dict:
    """The big model's generate call of one dispatch's MISS rows."""
    enc = [tok.encode(q)[:max_query_len] for q in queries]
    length = bucket_len(max_query_len)
    return {"rows": list(range(len(queries))), "tokens": pad_rows(enc, length), "prefix": []}
