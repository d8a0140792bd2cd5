"""Tweak-prompt construction (paper Appendix A).

Builds the Small LLM's input: instructions + cached prompt + cached
response + current prompt, token-level, with fixed-shape padding so
batched tweak prefills jit cleanly.

The prompt layout is defined ONCE, as ``TWEAK_SEGMENTS`` — an ordered
list of static (byte-identical across every tweak request) and field
(per-request) segments.  The host text path (``build_tweak_text``), the
token path (``build_tweak_batch``), the tensor assembly from field tokens
(``encode_static_segments`` + ``build_tweak_batch_tokens``) and
the prefill prefix/suffix split (``tweak_prefix_text`` /
``build_tweak_suffix_batch``) are all derived from it, so the prefix
split the KV prefix-cache reuses (DESIGN.md §9) cannot drift from the
text oracle.

Layout choice: the only variable-free run of tokens is the leading
instruction block, so every field segment lives in the suffix — the
suffix is ``[cached_q | cached_r | new_q]`` (with its interleaved static
cues), and the whole instruction prefix is shared KV across every TWEAK
request of a model.

Truncation: ``tokenizer.encode_batch``'s tail truncation used to cut the
trailing ``adapted response :`` cue off over-long prompts — the one
piece of the prompt that tells the Small LLM to start answering.  The
segment-aware encoders instead shave tokens from the *cached response*
field first (then cached query, then the new query); static segments are
never dropped.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tokenizer import HashWordTokenizer

# Condensed Appendix-A instruction (token budget matters at our scales; the
# full prompt text is reproduced in the paper — semantics preserved).
TWEAK_INSTRUCTION = (
    "you are part of a caching architecture . tailor the cached response to "
    "the current user prompt for relevance accuracy precision and clarity . "
    "do not reference the cached question . reflect the nuances and intent "
    "of the new prompt .")

# The paper appends this to every user query (Table 1, query preprocessing).
QUERY_SUFFIX = " answer briefly"

STATIC = "static"
# Field segments, in the order they appear and the order truncation
# consumes them (see _truncate_fields).
CACHED_QUERY = "cached_query"
CACHED_RESPONSE = "cached_response"
NEW_QUERY = "new_query"

# THE prompt layout.  Segment 0 is static by construction — it is the
# shared prefix whose KV state the serving engine computes once and
# reuses across every TWEAK request (DESIGN.md §9).
TWEAK_SEGMENTS: Tuple[Tuple[str, str], ...] = (
    (STATIC, TWEAK_INSTRUCTION + " cached prompt :"),
    (CACHED_QUERY, ""),
    (STATIC, ". cached response :"),
    (CACHED_RESPONSE, ""),
    (STATIC, ". user's current prompt :"),
    (NEW_QUERY, ""),
    (STATIC, ". adapted response :"),
)

# Truncation priority: cheapest-to-lose first.  The cached response is
# the longest and most redundant field (the Small LLM is rewriting it,
# a trimmed tail still carries the gist); the new query is trimmed last.
TRUNCATE_ORDER = (CACHED_RESPONSE, CACHED_QUERY, NEW_QUERY)


def preprocess_query(text: str) -> str:
    return text.strip() + QUERY_SUFFIX


def tweak_segments(new_query: str, cached_query: str,
                   cached_response: str) -> List[Tuple[str, str]]:
    """The canonical segment list with this request's field values filled."""
    vals = {CACHED_QUERY: cached_query, CACHED_RESPONSE: cached_response,
            NEW_QUERY: new_query}
    return [(kind, vals.get(kind, text)) for kind, text in TWEAK_SEGMENTS]


def tweak_prefix_text() -> str:
    """The static shared prefix — everything before the first field."""
    return TWEAK_SEGMENTS[0][1]


def tweak_prefix_ids(tokenizer: HashWordTokenizer) -> List[int]:
    """Token ids of the shared prefix (BOS included — it opens the prompt)."""
    return tokenizer.encode(tweak_prefix_text(), add_bos=True)


def build_tweak_text(new_query: str, cached_query: str,
                     cached_response: str) -> str:
    return " ".join(text for _, text in
                    tweak_segments(new_query, cached_query, cached_response))


def static_token_count(tokenizer: HashWordTokenizer, *,
                       suffix_only: bool = False) -> int:
    """Tokens the static segments alone occupy — the truncation floor.

    A prompt budget below this cannot produce a well-formed tweak prompt
    (``_truncate_fields`` never drops statics); serving layers validate
    against it up front so the failure surfaces BEFORE any state mutates.
    ``suffix_only`` counts just the post-prefix statics (no BOS).
    """
    segs = TWEAK_SEGMENTS[1:] if suffix_only else TWEAK_SEGMENTS
    n = 0
    first = not suffix_only
    for kind, text in segs:
        if kind != STATIC:
            continue
        n += len(tokenizer.encode(text, add_bos=first))
        first = False
    return n


# ------------------------------------------------------------ token paths

def _truncate_fields(seg_ids: List[Tuple[str, List[int]]],
                     max_len: int) -> List[Tuple[str, List[int]]]:
    """Shave the overflow from field segments, never from statics.

    Fields are trimmed (from their tail) in TRUNCATE_ORDER, so the
    trailing ``adapted response :`` cue always survives.  Raises when the
    static segments alone exceed ``max_len`` — no truncation can produce
    a well-formed prompt then, and silently dropping the cue is exactly
    the bug this replaces.
    """
    overflow = sum(len(ids) for _, ids in seg_ids) - max_len
    if overflow <= 0:
        return seg_ids
    budget = {k: len(ids) for k, ids in seg_ids if k != STATIC}
    for field in TRUNCATE_ORDER:
        if overflow <= 0:
            break
        take = min(budget.get(field, 0), overflow)
        budget[field] -= take
        overflow -= take
    if overflow > 0:
        static_total = sum(len(ids) for k, ids in seg_ids if k == STATIC)
        raise ValueError(
            f"tweak prompt budget {max_len} cannot fit the static prompt "
            f"segments ({static_total} tokens) — raise the budget or lower "
            f"max_new_tokens")
    return [(k, ids if k == STATIC else ids[:budget[k]])
            for k, ids in seg_ids]


def _encode_segments(tokenizer: HashWordTokenizer, segments,
                     add_bos: bool) -> List[Tuple[str, List[int]]]:
    out = []
    for i, (kind, text) in enumerate(segments):
        ids = tokenizer.encode(text, add_bos=add_bos and i == 0)
        out.append((kind, ids))
    return out


def encode_tweak_row(tokenizer: HashWordTokenizer, new_query: str,
                     cached_query: str, cached_response: str, max_len: int,
                     *, drop_prefix: bool = False) -> List[int]:
    """One tweak prompt (or its suffix) as ids, cue-preserving truncation.

    ``drop_prefix=True`` yields only the variable suffix (everything past
    the shared static prefix, no BOS) — the prefill input when the prefix
    KV comes from the prefix cache; prefix ids + suffix ids concatenate
    to exactly the full row.
    """
    segments = tweak_segments(new_query, cached_query, cached_response)
    if drop_prefix:
        segments = segments[1:]
    seg_ids = _encode_segments(tokenizer, segments, add_bos=not drop_prefix)
    seg_ids = _truncate_fields(seg_ids, max_len)
    return [t for _, ids in seg_ids for t in ids]


def _rows_to_batch(rows: Sequence[List[int]], max_len: int,
                   pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    toks = np.full((len(rows), max_len), pad_id, np.int32)
    mask = np.zeros((len(rows), max_len), np.float32)
    for i, ids in enumerate(rows):
        toks[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1.0
    return toks, mask


def build_tweak_batch(tokenizer: HashWordTokenizer, new_queries: List[str],
                      cached_queries: List[str], cached_responses: List[str],
                      max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full tweak prompts, (B, max_len) fixed shape, cue-preserving."""
    rows = [encode_tweak_row(tokenizer, n, c, r, max_len)
            for n, c, r in zip(new_queries, cached_queries, cached_responses)]
    return _rows_to_batch(rows, max_len, tokenizer.pad)


def build_tweak_suffix_batch(tokenizer: HashWordTokenizer,
                             new_queries: List[str],
                             cached_queries: List[str],
                             cached_responses: List[str],
                             max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Variable suffixes only (no BOS): the prefix-cached prefill input."""
    rows = [encode_tweak_row(tokenizer, n, c, r, max_len, drop_prefix=True)
            for n, c, r in zip(new_queries, cached_queries, cached_responses)]
    return _rows_to_batch(rows, max_len, tokenizer.pad)


def encode_static_segments(tokenizer: HashWordTokenizer,
                           device) -> Tuple[torch.Tensor, ...]:
    """Ids of each static segment, in layout order (BOS on the first), as
    int32 tensors on ``device``.

    The companion of ``build_tweak_batch_tokens``: encode once, reuse for
    every batch assembly.
    """
    out = []
    for kind, text in TWEAK_SEGMENTS:
        if kind == STATIC:
            out.append(torch.tensor(tokenizer.encode(text, add_bos=not out),
                                    dtype=torch.int32, device=device))
    return tuple(out)


def build_tweak_batch_tokens(static_ids, new_q, new_q_mask, cached_q,
                             cached_q_mask, cached_r, cached_r_mask):
    """Fixed-shape token-level assembly (no text round-trip), on the fields'
    device.

    ``static_ids``: the per-static-segment id vectors of
    ``encode_static_segments`` (on the fields' device); the fields are
    fixed-shape (B, L_*) int token and float mask tensors.  Output: the
    concatenation of every segment in ``TWEAK_SEGMENTS`` order, each static
    one broadcast over the batch — the layout the text oracle produces, by
    construction.  Padding stays in place (attention masks handle it).
    """
    fields = {CACHED_QUERY: (cached_q, cached_q_mask),
              CACHED_RESPONSE: (cached_r, cached_r_mask),
              NEW_QUERY: (new_q, new_q_mask)}
    b = new_q.shape[0]
    toks, masks = [], []
    static_iter = iter(static_ids)
    for kind, _ in TWEAK_SEGMENTS:
        if kind == STATIC:
            ids = next(static_iter)
            toks.append(ids.to(new_q.dtype)[None, :].expand(b, ids.shape[0]))
            masks.append(new_q_mask.new_ones(b, ids.shape[0]))
        else:
            t, m = fields[kind]
            toks.append(t)
            masks.append(m)
    return torch.cat(toks, dim=1), torch.cat(masks, dim=1)
