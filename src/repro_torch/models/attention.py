"""GQA attention (counterpart of ``src/repro/models/attention.py``).

* ``self_attention`` — full-sequence prefill, optionally over a stored
  shared prefix; returns the rotary-applied K/V for the cache.
* ``decode_attention`` — one new token against a dense KV cache, or
  through a block table against a paged one (``serving.paged_kv``).
* ``decode_attention_block`` — a (B, K) speculative verify block against
  a dense or a paged cache, at per-row positions.
* ``cross_attention``, ``cross_decode_attention`` — an encoder-decoder's
  decoder queries over the encoder memory's K/V (``cross_kv``), in prefill
  and in one decode step.

Prefill attention goes through ``kernels.flash_attention``, decode through
``kernels.decode_attention`` and ``kernels.paged_attention``: the
hand-written kernels on a CUDA tensor, their plain versions on a CPU
tensor.  A sliding-window stack keeps a dense ring buffer of ``min(capacity,
window)`` slots (``decode_attention``); its paged and block paths raise, as
the reference's do.

Cache writes are in place (the JAX package donates the buffers).  The
step-level parts that are the same in every layer (where a token lands,
the ``slot_pos`` update of all layers) run once per step in
``write_plan``; the layers then write only their own K/V.

Layouts follow the JAX package at the public functions: activations
(B,S,d), heads (B,S,H,dh), caches (B,T,Hk,dh).  The projection weights
are 2-D: ``w_qkv`` (d, (H+2Hk)*dh) holds w_q | w_k | w_v and ``w_o`` is
(H*dh, d); with ``cfg.qkv_bias`` the biases b_q | b_k | b_v are one
``b_qkv`` ((H+2Hk)*dh,) beside ``w_qkv`` (``checkpoint.convert`` builds them
from the JAX layout).
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attend_naive
from repro_torch.kernels.paged_attention import ops as paged_ops

from .config import ModelConfig
from .layers import apply_rope, dense_init


def init_attention(cfg: ModelConfig, generator, device):
    """One layer's attention weights, drawn as the JAX package draws w_q,
    w_k, w_v (d, heads*dh) and w_o (H*dh, d); the QKV biases start at zero,
    as the reference's do."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    w_q = dense_init((d, h * dh), dt, generator, device)
    w_k = dense_init((d, hk * dh), dt, generator, device)
    w_v = dense_init((d, hk * dh), dt, generator, device)
    p = {"w_qkv": torch.cat([w_q, w_k, w_v], dim=-1),
         "w_o": dense_init((h * dh, d), dt, generator, device)}
    if cfg.qkv_bias:
        p["b_qkv"] = torch.zeros((h + 2 * hk) * dh, dtype=dt, device=device)
    return p


def project_qkv(p, x, cfg: ModelConfig):
    """x (B,S,d) -> q (B,S,H,dh), k, v (B,S,Hk,dh); the biases, where the
    layer has them, are added after the projection in the weights' dtype,
    as the reference adds b_q, b_k and b_v."""
    b, s, _ = x.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    y = x @ p["w_qkv"]
    if "b_qkv" in p:
        y = y + p["b_qkv"]
    q, k, v = y.split([h * dh, hk * dh, hk * dh], dim=-1)
    return (q.reshape(b, s, h, dh), k.reshape(b, s, hk, dh),
            v.reshape(b, s, hk, dh).contiguous())


def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int, impl: str,
           block_q: int = 512, block_k: int = 512):
    """Prefill attention with the JAX package's ``impl`` semantics.

    "auto" resolves as the reference does (naive up to 2048 tokens, the
    fixed-block flash form beyond).  The Pallas impl of the reference
    drops the positions, so the port does not offer it.
    """
    if impl == "auto":
        impl = "xla_flash" if max(q.shape[1], k.shape[1]) > 2048 else "naive"
    if impl not in ("naive", "xla_flash"):
        raise NotImplementedError(f"attention_impl {impl!r}: use naive or xla_flash")
    return flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                     window=window, block_q=block_q,
                                     block_k=block_k, impl=impl)


def self_attention(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
                   window: int = 0, use_rope: bool = True, prefix=None):
    """Self attention over the sequence, causal unless ``causal`` is False
    (whisper's encoder), with rotary embeddings unless ``use_rope`` is False
    (whisper adds sinusoidal positions to its inputs instead).  Returns
    (out, (k, v, k_pos)).

    ``prefix`` is one layer's stored prefix KV (``{"k", "v", "slot_pos"}``,
    rope already applied); the queries, whose positions start after it,
    attend over ``[prefix | self]`` and the returned K/V cover both, ready
    to lay out slots ``[0, P+S)`` as an inline prefill would.
    """
    q, k, v = project_qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:       # the kernel reads dense (B,S,H,dh) rows; q and k are views into y
        q, k = q.contiguous(), k.contiguous()
    k_pos = positions
    if prefix is not None:
        k = torch.cat([prefix["k"].to(k.dtype), k], dim=1)
        v = torch.cat([prefix["v"].to(v.dtype), v], dim=1)
        k_pos = torch.cat([prefix["slot_pos"], positions], dim=1)
    ctx = attend(q, k, v, positions, k_pos, causal=causal, window=window,
                 impl=cfg.attention_impl, block_q=cfg.flash_block_q,
                 block_k=cfg.flash_block_k)
    b, s = x.shape[:2]
    return ctx.reshape(b, s, -1) @ p["w_o"], (k, v, k_pos)


def init_kv_cache(layers: int, batch: int, capacity: int, cfg: ModelConfig, device,
                  dtype=None):
    """Stacked dense caches: k/v (L,B,T,Hk,dh), slot_pos (L,B,T) (-1 = empty)."""
    dt = torch_dtype(dtype or cfg.dtype)
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((layers, batch, capacity, hk, dh), dtype=dt, device=device),
        "v": torch.zeros((layers, batch, capacity, hk, dh), dtype=dt, device=device),
        "slot_pos": torch.full((layers, batch, capacity), -1, dtype=torch.int32,
                               device=device),
    }


def fill_kv_cache(cache, layer: int, k, v, positions):
    """Write a prefill's k/v (B,S,Hk,dh) into slots [0, S) of one layer, in
    place (the JAX package's dynamic_update_slice on a fresh buffer)."""
    s = k.shape[1]
    cache["k"][layer, :, :s] = k
    cache["v"][layer, :, :s] = v
    cache["slot_pos"][layer, :, :s] = positions


def decode_attention(p, x, cache, layer: int, pos, cache_len, cfg: ModelConfig,
                     *, window: int = 0, plan=None, use_rope: bool = True):
    """One token x (B,1,d) against one layer's cache, updated in place (the
    JAX package donates the buffer).

    Dense cache: ``pos`` is the host int of every row.  The reference writes
    the token into slot ``pos`` and attends with ``slot_pos >= 0 & slot_pos
    <= pos``.  A dense global cache filled by prefill holds position t in
    slot t, so that mask is ``t < pos + 1`` and the kernel takes
    ``cache_len = pos + 1`` (B,) int32, built once per step by the caller.

    Windowed (``window > 0``): the cache is a ring of ``cap = min(capacity,
    window)`` slots, the token goes to slot ``pos % cap`` (the reference's
    rule) and the reference keeps ``slot_pos >= 0 & slot_pos <= pos &
    slot_pos > pos - window``.  Before the ring wraps, slot t holds position
    t for t <= pos and -1 after it; once it has wrapped (or prefill laid a
    longer prompt out in ring order), every slot holds one of the last
    ``cap`` positions ``(pos - cap, pos]``, all inside the window since
    ``cap <= window``.  Either way the mask is ``t < min(pos + 1, cap)``, so
    the kernel takes ``cache_len = min(pos + 1, cap)``, built by the caller.
    The ring's key order differs from position order only in the order of
    the softmax sums.

    Paged cache (``"kp"`` in it): ``pos`` is (B,) per row and ``plan`` the
    step's ``write_plan`` (which already set ``slot_pos``).  The token goes
    through the block table to slot ``min(pos, cap-1)`` and the kernel reads
    the pages, keeping ``slot_pos >= 0``; the model's ``slot_pos <= pos``
    holds for every written slot of the caches the serving paths build
    (``rewind_kv`` empties every slot at or past ``pos``), which the tests
    check.  The dense cache is never built.

    ``use_rope`` False (whisper's decoder) leaves q and k unrotated.
    """
    if window > 0 and "kp" in cache:
        raise NotImplementedError("paged KV decode is global-attention only; windowed "
                                  "stacks must use the dense ring-buffered cache")
    b = x.shape[0]
    q, k, v = project_qkv(p, x, cfg)
    if use_rope:
        cur = (torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
               if plan is None else plan["cur"])
        q = apply_rope(q, cur, cfg.rope_theta)
        k = apply_rope(k, cur, cfg.rope_theta)
    if "kp" in cache:
        cache["kp"][layer, plan["page"], plan["off"]] = k.to(cache["kp"].dtype)
        cache["vp"][layer, plan["page"], plan["off"]] = v.to(cache["vp"].dtype)
        ctx = paged_ops.paged_decode_attention(
            q[:, 0].contiguous(), cache["kp"][layer], cache["vp"][layer],
            cache["block_tbl"], cache["slot_pos"][layer])
        return ctx.reshape(b, 1, -1) @ p["w_o"]
    capacity = cache["k"].shape[2]
    slot = pos % capacity if window > 0 else min(pos, capacity - 1)
    cache["k"][layer, :, slot] = k[:, 0]
    cache["v"][layer, :, slot] = v[:, 0]
    cache["slot_pos"][layer, :, slot] = pos
    ctx = decode_ops.decode_attention(q[:, 0].contiguous(), cache["k"][layer],
                                      cache["v"][layer], cache_len)
    return ctx.reshape(b, 1, -1) @ p["w_o"]


def write_plan(cache, pos, kblk: int, *, block: bool):
    """Where a step's tokens land, and the ``slot_pos`` update of every
    layer, done once per step: ``kblk`` tokens per row at absolute
    positions ``pos + i`` (pos (B,) int32).

    Returns ``{"cur" (B,k) positions, "rows"/"slot" (B,k) targets,
    "page"/"off" (paged), "src"/"stale" (dense blocks)}``.  The plain
    decode step (``block=False``, one token) writes slot ``min(pos,
    cap-1)``.  In a verify block (``block=True``, any k), positions past
    the capacity do not write (JAX drops those scatters, a CUDA index past
    the end would fault): a paged cache sends them to the TRASH page; a
    dense cache points them at slot ``cap-1`` with the value that slot gets
    anyway (the block's own token for it, or its old contents when the
    whole block is past the end), so the duplicate writes agree.
    """
    b = pos.shape[0]
    dev = pos.device
    sp = cache["slot_pos"]                                   # (L,B,cap)
    cap = sp.shape[-1]
    iota = torch.arange(kblk, dtype=torch.int32, device=dev)
    cur = pos[:, None] + iota[None, :]                        # (B,k)
    rows = torch.arange(b, dtype=torch.int32, device=dev)[:, None].expand(b, kblk)
    slot = cur.clamp(max=cap - 1)
    if not block:
        sp[:, rows, slot] = cur                               # the decode step's write
        fits, stale = None, None
    else:
        fits = cur < cap
        inside = (pos < cap)[:, None]
        stale = ~inside                                       # no slot of the block fits
        val = torch.where(fits, cur, cap - 1)
        sp[:, rows, slot] = torch.where(stale[None], sp[:, :, cap - 1:cap], val[None])
    plan = {"cur": cur, "rows": rows, "slot": slot}
    if "kp" in cache:
        page = cache["kp"].shape[2]
        pg = cache["block_tbl"].gather(1, (slot // page).long())
        if fits is not None:
            pg = torch.where(fits, pg, cache["kp"].shape[1] - 1)   # overflow -> TRASH
        plan.update(page=pg.long(), off=(slot % page).long())
    elif fits is not None:
        plan["stale"] = stale
        if kblk > 1:
            # block index of the token that lands in each target slot
            src = torch.where(fits, iota[None, :], (cap - 1 - pos)[:, None]).clamp(0, kblk - 1)
            plan["src"] = src.long()
    return plan


def _dense_block_write(buf, new, plan):
    """Write one layer's block K or V (B,k,Hk,dh) into ``buf`` (B,cap,Hk,dh)."""
    rows, slot = plan["rows"], plan["slot"]
    val = new
    if "src" in plan:          # k > 1: the token each target slot takes
        val = new.gather(1, plan["src"][:, :, None, None].expand(-1, -1, *new.shape[2:]))
    if "stale" in plan:        # rows whose whole block is past the capacity keep slot cap-1
        val = torch.where(plan["stale"][:, :, None, None], buf[:, -1:], val)
    buf[rows, slot] = val.to(buf.dtype)


def decode_attention_block(p, x, cache, layer: int, pos, plan, cfg: ModelConfig):
    """A (B,k) verify block x (B,k,d) at per-row positions ``pos + i``
    against one layer's dense or paged cache, written in place; ``plan``
    is the step's ``write_plan`` (``slot_pos`` already set).

    The k tokens' K/V are written optimistically at slots ``[pos, pos+k)``
    (the caller rewinds rejected ones, ``paged_kv.rewind_kv``) and query i
    attends causally.  Paged: the kernel keeps ``slot_pos >= 0 & slot_pos
    <= pos + i``, the model's mask.  Dense: the kernel keeps ``t < pos +
    i + 1``, equal to the model's mask on these caches, whose slot t holds
    position t up to the block's end and -1 after it (prefill, block
    writes and ``rewind_kv`` keep it so; the tests check it).
    """
    b, kblk = x.shape[0], x.shape[1]
    q, k, v = project_qkv(p, x, cfg)
    q = apply_rope(q, plan["cur"], cfg.rope_theta)
    k = apply_rope(k, plan["cur"], cfg.rope_theta)
    if "kp" in cache:
        cache["kp"][layer, plan["page"], plan["off"]] = k.to(cache["kp"].dtype)
        cache["vp"][layer, plan["page"], plan["off"]] = v.to(cache["vp"].dtype)
        ctx = paged_ops.paged_decode_attention_block(
            q.contiguous(), cache["kp"][layer], cache["vp"][layer], cache["block_tbl"],
            cache["slot_pos"][layer], pos)
    else:
        _dense_block_write(cache["k"][layer], k, plan)
        _dense_block_write(cache["v"][layer], v, plan)
        ctx = decode_ops.decode_attention_block(q.contiguous(), cache["k"][layer],
                                                cache["v"][layer], pos)
    return ctx.reshape(b, kblk, -1) @ p["w_o"]


# ------------------------------------------------------------- cross attn

def init_cross_attention(cfg: ModelConfig, generator, device):
    """A decoder layer's cross-attention weights, in ``init_attention``'s
    layout and draws (the reference's ``init_cross_attention`` is its
    ``init_attention``)."""
    return init_attention(cfg, generator, device)


def _cross_weights(p, cfg: ModelConfig, part: str):
    """(weight, bias or None) of the query ("q") or key-value ("kv") columns
    of ``w_qkv`` / ``b_qkv``."""
    hd = cfg.num_heads * cfg.resolved_head_dim
    cols = slice(None, hd) if part == "q" else slice(hd, None)
    b = p.get("b_qkv")
    return p["w_qkv"][:, cols], None if b is None else b[cols]


def cross_query(p, x, cfg: ModelConfig):
    """x (B,S,d) -> cross-attention queries (B,S,H,dh), contiguous."""
    w, bias = _cross_weights(p, cfg, "q")
    q = x @ w
    if bias is not None:
        q = q + bias
    return q.reshape(*x.shape[:2], cfg.num_heads, cfg.resolved_head_dim)


def cross_kv(p, memory, cfg: ModelConfig):
    """memory (B,F,d) -> one layer's cross K and V (B,F,Hk,dh), contiguous:
    projected once a prefill, for its attention and for the decode caches
    (the reference projects them twice, in ``cross_attention`` and in
    ``encdec._cross_kv``)."""
    w, bias = _cross_weights(p, cfg, "kv")
    kv = memory @ w
    if bias is not None:
        kv = kv + bias
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k, v = kv.split(hk * dh, dim=-1)
    shape = (*memory.shape[:2], hk, dh)
    return k.reshape(shape).contiguous(), v.reshape(shape).contiguous()


def cross_attention(p, x, k, v, cfg: ModelConfig):
    """Decoder queries x (B,S,d) over one layer's cross K/V (no rope, no
    mask): the prefill kernel, non-causal, every position 0, and impl
    "naive" as the reference fixes it (its padded "xla_flash" form would
    let the zero keys that pad F to a whole block take weight)."""
    b, s = x.shape[:2]
    q = cross_query(p, x, cfg)
    zeros = lambda n: torch.zeros((b, n), dtype=torch.int32, device=x.device)
    ctx = flash_ops.flash_attention(q, k, v, zeros(s), zeros(k.shape[1]), causal=False,
                                    window=0, block_q=cfg.flash_block_q,
                                    block_k=cfg.flash_block_k, impl="naive")
    return ctx.reshape(b, s, -1) @ p["w_o"]


def cross_decode_attention(p, x, k, v, enc_len, cfg: ModelConfig):
    """One token x (B,1,d) over one layer's stored cross K/V (B,F,Hk,dh):
    the dense decode kernel with ``enc_len`` (B,) int32 = F on every row, so
    every key is kept, the function of the reference's naive composite at
    positions 0 without a causal mask."""
    q = cross_query(p, x, cfg)
    ctx = decode_ops.decode_attention(q[:, 0].contiguous(), k, v, enc_len)
    return ctx.reshape(x.shape[0], 1, -1) @ p["w_o"]


def encoder_attention(p, x, positions, valid, cfg: ModelConfig):
    """Bidirectional masked attention for the embedder, plain PyTorch (the
    JAX package computes it in XLA, not in a kernel)."""
    q, k, v = project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ctx = attend_naive(q, k, v, positions, positions, False, 0, extra_mask=valid)
    b, s = x.shape[:2]
    return ctx.reshape(b, s, -1) @ p["w_o"]
