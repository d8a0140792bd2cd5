"""The yardstick's own arithmetic: the card's peaks and the operations and
bytes of the work the traffic needs, from the configuration and the
lengths the harness generated (never from what a kernel reads).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit; PERF.md gives the card's own limit beside every number):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def active_params(cfg: dict) -> int:
    """Parameters a token multiplies through: attention, the MLP or the k
    experts it is routed to and the router, the LM head (the embedding is a
    lookup, no product)."""
    d, nh, hk, dh = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * (nh + 2 * hk) * dh + nh * dh * d
    if cfg.get("num_experts"):
        ffn = cfg["experts_per_token"] * 3 * d * cfg["moe_d_ff"] + d * cfg["num_experts"]
    else:
        ffn = (3 if cfg["mlp_type"] == "swiglu" else 2) * d * cfg["d_ff"]
    return cfg["num_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def attention_flops(cfg: dict, context: int) -> int:
    """QK^T and PV of one token over ``context`` keys, every layer."""
    keys = min(context, cfg["sliding_window"]) if cfg.get("sliding_window") else context
    return 4 * cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] * keys


def row_flops(cfg: dict, prompt: int, computed_from: int, generated: int) -> int:
    """Model FLOPs of one served row: the prompt positions ``computed_from``
    .. ``prompt`` - 1 (a shared prefix before them is reused, not computed),
    then ``generated`` - 1 decode steps (the first token comes from the
    prefill): 2 x active parameters a token, plus attention."""
    n = active_params(cfg)
    total = 0
    for pos in range(computed_from, prompt):
        total += 2 * n + attention_flops(cfg, pos + 1)
    for t in range(1, generated):
        total += 2 * n + attention_flops(cfg, prompt + t)
    return total


def decode_kv_bytes(cfg: dict, prompt: int, generated: int, elem: int = 2) -> int:
    """K and V bytes the decode steps of one row must read: step t attends
    over prompt + t keys (a window caps them) in every layer."""
    per_key = 2 * cfg["num_kv_heads"] * cfg["head_dim"] * elem * cfg["num_layers"]
    total = 0
    for t in range(1, generated):
        keys = prompt + t
        if cfg.get("sliding_window"):
            keys = min(keys, cfg["sliding_window"])
        total += keys * per_key
    return total


def scan_bytes(rows: int, dim: int, queries: int, elem: int = 4) -> int:
    """A flat top-k scan over the ``rows`` entries a bank holds: each
    entry's embedding once, and the queries (a bank kept compact needs no
    validity flag)."""
    return (rows + queries) * dim * elem
