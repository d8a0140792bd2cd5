"""The benchmark's own weights, made on the device from the seed and handed
to both the program and the reference.

Every leaf of a model lives in one flat buffer of its serving dtype, drawn
by one ``normal_`` call from a ``torch.Generator`` on the device and then
scaled leaf by leaf to its fan-in (the router and the norms, float32, in a
second buffer).  The leaves are views in the parameter layout the program
takes (``repro_torch/models``: ``w_qkv`` (d, (H+2Hk)*dh), ``w_o``, fused
``w_gate_up``, experts stacked (E, d, 2f)), which is a file format here, not
code of the program.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DRAW = 1 << 30     # elements a draw: a few calls for the largest model


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def lm_leaves(cfg: dict):
    """[(path, shape, dtype name, std or 'one'/'zero')] of a decoder-only
    attention or MoE stack."""
    d, nh, hk, dh = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    v, f, dt = padded_vocab(cfg["vocab_size"]), cfg["d_ff"], cfg["dtype"]
    out = [(("embed",), (v, d), dt, 0.02), (("lm_head",), (d, v), dt, d ** -0.5)]
    out += _norm(("final_norm",), d, cfg["norm_type"])
    for i in range(cfg["num_layers"]):
        L = ("layers", i)
        out += _norm(L + ("norm1",), d, cfg["norm_type"]) + _norm(L + ("norm2",), d,
                                                                   cfg["norm_type"])
        out += [(L + ("attn", "w_qkv"), (d, (nh + 2 * hk) * dh), dt, d ** -0.5),
                (L + ("attn", "w_o"), (nh * dh, d), dt, (nh * dh) ** -0.5)]
        if cfg.get("qkv_bias"):
            out.append((L + ("attn", "b_qkv"), ((nh + 2 * hk) * dh,), dt, 0.02))
        if cfg.get("num_experts"):
            e, fe = cfg["num_experts"], cfg["moe_d_ff"]
            out += [(L + ("moe", "router"), (d, e), "float32", d ** -0.5),
                    (L + ("moe", "w_gate_up"), (e, d, 2 * fe), dt, d ** -0.5),
                    (L + ("moe", "w_down"), (e, fe, d), dt, fe ** -0.5)]
        elif cfg["mlp_type"] == "swiglu":
            out += [(L + ("mlp", "w_gate_up"), (d, 2 * f), dt, d ** -0.5),
                    (L + ("mlp", "w_down"), (f, d), dt, f ** -0.5)]
        else:
            out += [(L + ("mlp", "w_up"), (d, f), dt, d ** -0.5),
                    (L + ("mlp", "w_down"), (f, d), dt, f ** -0.5)]
    return out


def embedder_leaves(cfg: dict):
    """The MiniLM encoder's leaves (float32, layer norms, gelu MLP)."""
    d, f, dt = cfg["d_model"], cfg["d_ff"], cfg["dtype"]
    nh, dh = cfg["num_heads"], cfg["head_dim"]
    out = [(("embed",), (padded_vocab(cfg["vocab_size"]), d), dt, 0.02)]
    out += _norm(("final_norm",), d, "layernorm")
    for i in range(cfg["num_layers"]):
        L = ("layers", i)
        out += _norm(L + ("norm1",), d, "layernorm") + _norm(L + ("norm2",), d, "layernorm")
        out += [(L + ("attn", "w_qkv"), (d, 3 * nh * dh), dt, d ** -0.5),
                (L + ("attn", "w_o"), (nh * dh, d), dt, (nh * dh) ** -0.5),
                (L + ("mlp", "w_up"), (d, f), dt, d ** -0.5),
                (L + ("mlp", "w_down"), (f, d), dt, f ** -0.5)]
    return out


def _norm(path, d, kind):
    out = [(path + ("scale",), (d,), "float32", "one")]
    if kind == "layernorm":
        out.append((path + ("bias",), (d,), "float32", "zero"))
    return out


def numel(leaves) -> int:
    n = 0
    for _, shape, _, _ in leaves:
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def make(leaves, generator: torch.Generator, device) -> dict:
    """The tree of ``leaves``: one buffer per dtype, one draw per buffer,
    then each leaf scaled (or set to 1 or 0) in place."""
    tree: dict = {}
    by_dtype: dict = {}
    for leaf in leaves:
        by_dtype.setdefault(leaf[2], []).append(leaf)
    for dt, group in by_dtype.items():
        buf = torch.empty(numel(group), dtype=DTYPES[dt], device=device)
        for part in buf.split(DRAW):
            part.normal_(generator=generator)
        at = 0
        for path, shape, _, std in group:
            n = numel([(path, shape, dt, std)])
            t = buf[at:at + n].view(shape)
            at += n
            if std == "one":
                t.fill_(1.0)
            elif std == "zero":
                t.zero_()
            else:
                t.mul_(std)
            _put(tree, path, t)
    return _lists(tree)


def _put(tree, path, t):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = t


def _lists(tree):
    """Dicts keyed 0..n-1 (the layers) to lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out
