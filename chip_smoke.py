#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TweakLLM on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Prints one JSON object per line:

  env     the card (nvidia-smi name and power limit), torch/CUDA versions and
          the seconds the kernels took to build from ``src/repro_torch/csrc``;
  kernel  one line per Hopper kernel and main-path shape: max |kernel - plain|
          against its tolerance, the kernel's time per call (CUDA events over
          back-to-back calls, ``ms``; and its kernels' device time from the
          profiler, ``device_ms``), the plain version's, one PyTorch library
          call's (a yardstick, never used by the port) and the least time the
          card could take (bytes / 3.35 TB/s or operations / peak rate,
          whichever is larger);
  serve   the full-width stack (``build_engine(model="llama-3.1-8b")``):
          a restored bank of random unit vectors, a few hundred populated
          pairs, then batches of 8 through ``TweakLLMEngine.handle_batch``
          with exact repeats, one-word edits and fresh queries; routing
          counts, tokens, per-batch latency and kernel launches;
  profile where the time goes, after the serve run: one small-model decode
          step timed alone (host enqueue, wall and device time), then one
          more serve batch under ``torch.profiler`` (wall time, device-busy
          share, device time by kernel name);
  kernels the ported kernels with their launches in the serve run;

then the raw nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero without the last
line; it does so too without CUDA or outside a checkout of the repo.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
N_BATCHES = 6                  # serve batches of 8 in the main run
MAX_NEW_TOKENS = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn`` per call: the summed durations of the GPU kernels
    it launches, from ``torch.profiler``.  For a kernel of a few microseconds
    the CUDA-event time of back-to-back calls (``time_ms``) is the host's
    launch rate instead; this is the card's own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(r[1] for r in kernel_rows(prof))
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / reps


def kernel_rows(prof):
    """(kernel name, device microseconds, launches) of every GPU kernel in a
    profile, largest first; CPU-side ops are left out so nothing counts twice."""
    from torch.autograd import DeviceType
    rows = [(e.key, float(e.self_device_time_total), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def bound(bytes_moved: float, flops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:     # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} exceeds tolerance {tol}")


# ------------------------------------------------------------------ kernels

def flash_case(label, b, sq, prefix, h, hk, dh, block, impl, gen):
    """The prefill kernel at one main-path shape: queries at [prefix,
    prefix+sq) over keys [0, prefix+sq), bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda")
    sk = prefix + sq
    q = torch.randn(b, sq, h, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    q_pos = torch.arange(prefix, sk, device=dev, dtype=torch.int32).expand(b, sq).contiguous()
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(b, sk).contiguous()
    run = lambda: ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=0,
                                      block_q=block, block_k=block, impl=impl)
    out = run()
    if impl == "naive":
        plain = lambda: ref.attend_naive(q, k, v, q_pos, k_pos, True, 0)
        want = ref.attend_naive(q.float(), k.float(), v.float(), q_pos, k_pos, True, 0)
    else:
        plain = lambda: ref.attend_blockwise(q, k, v, q_pos, k_pos, True, 0, block, block)
        want = ref.attend_blockwise(q.float(), k.float(), v.float(), q_pos, k_pos, True, 0,
                                    block, block)
    err = (out.float() - want).abs().max().item()
    tol = 2e-2   # bf16 output (ulp 2^-8 near 1) against an fp32 evaluation
    check(f"flash_attention[{label}]", err, tol)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (k_pos[0][None, :] <= q_pos[0][:, None])
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                     enable_gqa=True)
    pairs = b * h * int(mask.sum().item())          # allowed (query, key) pairs
    moved = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * (sq + sk) * b
    bms, by = bound(moved, 4.0 * pairs * dh, "bf16")
    return {"phase": "kernel", "name": "flash_attention", "case": label,
            "shape": {"B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "dh": dh,
                      "block": block, "impl": impl, "dtype": "bfloat16"},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=5), "library_ms": time_ms(library),
            "bound_ms": bms, "bound_by": by}, (run, library, 10)


def decode_case(label, b, h, hk, dh, t, cache_len, layers, gen):
    """The decode kernel at one main-path shape, bf16.  The timed loop walks
    ``layers`` distinct caches, as a decode step walks its layers, so each
    launch finds its K/V outside the 50 MB L2, as the serve path does."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    dev = torch.device("cuda")
    q = torch.randn(b, h, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    ks = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
          for _ in range(layers)]
    vs = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
          for _ in range(layers)]
    lens = torch.full((b,), cache_len, device=dev, dtype=torch.int32)
    out = ops.decode_attention(q, ks[0], vs[0], lens)
    want = ref.decode_attention_ref(q.float(), ks[0].float(), vs[0].float(), lens)
    err = (out.float() - want).abs().max().item()
    tol = 2e-2
    check(f"decode_attention[{label}]", err, tol)
    step = [0]

    def run():
        j = step[0] % layers
        step[0] += 1
        return ops.decode_attention(q, ks[j], vs[j], lens)

    plain = lambda: ref.decode_attention_ref(q, ks[0], vs[0], lens)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    kts = [x.transpose(1, 2).contiguous() for x in ks]
    vts = [x.transpose(1, 2).contiguous() for x in vs]

    def library():
        j = step[0] % layers
        step[0] += 1
        return F.scaled_dot_product_attention(q4, kts[j], vts[j], attn_mask=mask,
                                              enable_gqa=True)

    moved = 2 * 2 * b * cache_len * hk * dh + 2 * 2 * q.numel() + 4 * b
    bms, by = bound(moved, 4.0 * b * h * cache_len * dh, "bf16")
    chunk, nsplit = ops.split_plan(b, hk, t)
    return {"phase": "kernel", "name": "decode_attention", "case": label,
            "shape": {"B": b, "H": h, "Hk": hk, "dh": dh, "T": t, "cache_len": cache_len,
                      "splits": nsplit, "chunk": chunk, "dtype": "bfloat16"},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run, reps=layers),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library, reps=layers),
            "bound_ms": bms, "bound_by": by}, (run, library, layers)


def cosine_case(label, b, n, d, k, block_n, gen):
    """The lookup kernel on a bank of the serve path's size (fp32; the
    403 MB bank does not fit in L2, so every launch reads it cold)."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref
    dev = torch.device("cuda")
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=gen), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=gen), dim=-1)
    valid = torch.rand(n, device=dev, generator=gen) < 0.98
    db[:4] = q[:4]                         # exact hits at rows 0-3 ...
    db[4:8] = q[:4]                        # ... tied at rows 4-7: the lower index wins
    valid[:8] = True
    run = lambda: ops.cosine_topk(q, db, valid, k=k, block_n=block_n)
    s, i = run()
    s_ref, i_ref = ref.cosine_topk_ref(q, db, k, valid)
    err = (s - s_ref).abs().max().item()
    tol = 1e-5
    check(f"cosine_topk[{label}]", err, tol)
    gaps = torch.diff(s_ref, dim=1).abs()
    sure = torch.ones_like(s_ref, dtype=torch.bool)
    sure[:, 1:] &= gaps > tol
    sure[:, :-1] &= gaps > tol
    if not torch.equal(i[sure], i_ref[sure]):
        raise AssertionError(f"cosine_topk[{label}]: indices differ from the plain version")
    hits = torch.stack([torch.arange(4), torch.arange(4, 8)], 1).to(i)
    if not torch.equal(i[:4, :2], hits):
        raise AssertionError(f"cosine_topk[{label}]: exact hits or ties misplaced: {i[:4]}")
    plain = lambda: ref.cosine_topk_ref(q, db, k, valid)
    library = lambda: torch.topk(torch.where(valid, q @ db.T, -torch.inf), k, dim=1)
    n_valid = int(valid.sum().item())
    moved = n + 4 * n_valid * d + 4 * b * d + 8 * b * k    # invalid rows are never read
    bms, by = bound(moved, 2.0 * b * n_valid * d, "fp32")
    return {"phase": "kernel", "name": "cosine_topk", "case": label,
            "shape": {"B": b, "N": n, "D": d, "k": k, "block_n": block_n,
                      "valid": n_valid, "dtype": "float32"},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=5), "library_ms": time_ms(library, reps=5),
            "bound_ms": bms, "bound_by": by}, (run, library, 10)


def kernel_phase(prefix_len: int, seed: int):
    """(kernel line, (kernel call, library call, profiled calls)) per case."""
    import torch
    from repro_torch.configs import llama31_8b
    from repro_torch.launch.serve import LLAMA_CAPACITY, LLAMA_FLASH_BLOCK
    cfg = llama31_8b.CONFIG
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        flash_case("small-suffix-over-prefix", 8, 128, prefix_len, h, hk, dh,
                   LLAMA_FLASH_BLOCK, "xla_flash", gen),
        flash_case("big-miss-prefill", 8, 64, 0, h, hk, dh, cfg.flash_block_k, "naive", gen),
        decode_case("small-tweak-decode", 8, h, hk, dh, prefix_len + 128 + 33,
                    prefix_len + 128 + 16, cfg.num_layers, gen),
        decode_case("big-miss-decode", 8, h, hk, dh, 64 + 33, 64 + 16, cfg.num_layers, gen),
        cosine_case("serve-bank", 8, LLAMA_CAPACITY, 384, 4, 1024, gen),
    ]


# ------------------------------------------------------------------ serve

def plan_traffic(model: str, device, seed: int, n_pop: int, n_batches: int, bsz: int,
                 vocab: int):
    """Populated pairs, serve batches and the router threshold.

    With random weights the embedder cannot tell a paraphrase from a fresh
    query, so TWEAK traffic is one-word edits of populated queries and the
    threshold sits in the gap between the edits' similarity to their
    populated partner and the fresh queries' best similarity to anything
    populated, both measured with the stack's own embedder.
    """
    import numpy as np
    import torch
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.data import QuestionPairGenerator, synthesize_response
    from repro_torch.launch.serve import build_embedder
    from repro_torch.models.embedder import encode
    from repro_torch.serving.batcher import pad_to_buckets
    from repro_torch.tokenizer import HashWordTokenizer

    g = QuestionPairGenerator(seed=seed)
    pop = [g._random_query() for _ in range(n_pop)]
    fresh = [g._random_query().text for _ in range(4 * n_batches * bsz)]
    edits = [q.text + " please" for q in pop]
    eparams, ecfg = build_embedder(model, device=device, vocab=vocab, seed=seed)
    tok = HashWordTokenizer(vocab)

    def embed(texts):
        t, m = tok.encode_batch([preprocess_query(x) for x in texts], 64)
        t, m, n = pad_to_buckets(t, m)
        with torch.no_grad():
            return encode(eparams, torch.as_tensor(t, device=device).long(),
                          torch.as_tensor(m, device=device), ecfg)[:n]

    e_pop = embed([q.text for q in pop])
    edit_sim = (embed(edits) * e_pop).sum(-1).cpu().numpy()
    fresh_sim = (embed(fresh) @ e_pop.T).amax(-1).cpu().numpy()
    lo, hi = np.quantile(fresh_sim, 0.5), np.quantile(edit_sim, 0.5)
    if not hi > lo + 0.01:
        raise AssertionError(f"no similarity gap to route on: fresh median {lo}, "
                             f"edit median {hi}")
    thr = float((lo + hi) / 2)
    edit_ok = [i for i in range(n_pop) if edit_sim[i] > thr + 0.005]
    fresh_ok = [f for f, s in zip(fresh, fresh_sim) if s < thr - 0.005]
    rng = np.random.default_rng(seed)
    batches, planned = [], {"exact": 0, "tweak": 0, "miss": 0}
    for bi in range(n_batches):
        rows = ([pop[int(i)].text for i in rng.choice(n_pop, 3, replace=False)]
                + [edits[int(i)] for i in rng.choice(edit_ok, 3, replace=False)]
                + fresh_ok[2 * bi: 2 * bi + bsz - 6])
        planned["exact"] += 3
        planned["tweak"] += 3
        planned["miss"] += len(rows) - 6
        batches.append([rows[int(i)] for i in rng.permutation(len(rows))])
    pairs = ([q.text for q in pop], [synthesize_response(q.text, q.topic, q.intent)
                                     for q in pop])
    calib = {"threshold": thr, "edit_sim_median": float(hi), "fresh_sim_median": float(lo),
             "edits_above": len(edit_ok), "fresh_below": len(fresh_ok), "planned": planned}
    return pairs, batches, calib


def fill_bank(eng, n_fill: int, seed: int) -> None:
    """A restored bank: seeded random unit vectors in rows [0, n_fill) (near
    cosine 0 to any query; they never route), written in place."""
    import torch
    st = eng.state
    gen = torch.Generator(device=st["emb"].device).manual_seed(seed + 7)
    emb = torch.randn(n_fill, st["emb"].shape[1], device=st["emb"].device, generator=gen)
    st["emb"][:n_fill] = torch.nn.functional.normalize(emb, dim=-1)
    st["valid"][:n_fill] = True
    st["ptr"].fill_(n_fill)
    st["size"].fill_(n_fill)


def prefix_reuse_check(eng, queries, cached, max_new_tokens: int):
    """The TWEAK path's prefix reuse against a full-prompt prefill of the
    same rows on the small model.  On the card the prefix K/V come from a
    matmul at another row count, so logits may differ by rounding: the
    greedy first token must agree on every row whose top-2 logit margin
    exceeds twice the largest logit difference, and the share of equal
    generated tokens is reported."""
    import numpy as np
    import torch
    from repro_torch.core import tweak as tweak_lib
    from repro_torch.serving.batcher import bucket_len, pad_to_buckets
    cqs, crs = [c[0] for c in cached], [c[1] for c in cached]
    st, sm = tweak_lib.build_tweak_suffix_batch(eng.tok, queries, cqs, crs, 1024)
    width = bucket_len(int(sm.sum(1).max()))
    st = pad_to_buckets(st[:, :width], sm[:, :width])[0]
    pc = eng.small.build_prefix_cache(tweak_lib.tweak_prefix_ids(eng.tok), st.shape[0])
    full = np.concatenate(
        [np.broadcast_to(np.asarray(pc.token_ids, np.int32), (st.shape[0], pc.length)), st], 1)
    small, dev = eng.small, eng.device
    cap = full.shape[1] + max_new_tokens + 1
    lp, _ = small.model.prefill_with_prefix(
        small.params, {"tokens": torch.as_tensor(st, device=dev).long()}, cap, pc.caches)
    lf, _ = small.model.prefill(small.params,
                                {"tokens": torch.as_tensor(full, device=dev).long()}, cap)
    diff = (lp - lf).abs().max().item()
    top2 = lf.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff + 1e-3
    if not torch.equal(lp.argmax(-1)[sure], lf.argmax(-1)[sure]):
        raise AssertionError("prefix-reuse prefill disagrees with the full prefill "
                             f"on a clear greedy token (max logit diff {diff})")
    a = small.generate_with_lengths({"tokens": st}, max_new_tokens=max_new_tokens, seed=0,
                                    prefix_cache=pc)[0]
    b = small.generate_with_lengths({"tokens": full}, max_new_tokens=max_new_tokens, seed=0)[0]
    n = len(queries)
    return {"max_logit_diff": diff, "clear_rows": int(sure.sum().item()),
            "rows": int(sure.numel()), "token_match": float((a[:n] == b[:n]).mean())}


def serve_phase(model: str, device, seed: int, n_batches: int, max_new_tokens: int,
                n_pop: int = 256, bsz: int = 8):
    """Serve ``n_batches`` batches through ``handle_batch`` and check them:
    (serve line, launches, engine, one more planned batch for the profile)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_engine, model_configs

    vocab = model_configs(model)[0].vocab_size
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pairs, planned, calib = plan_traffic(model, device, seed, n_pop, n_batches + 1, bsz,
                                         vocab)
    batches, spare = planned[:-1], planned[-1]
    eng = build_engine(model=model, device=device, seed=seed, threshold=calib["threshold"])
    fill_bank(eng, eng.cache_cfg.capacity - 4 * n_pop - (n_batches + 1) * bsz, seed)
    eng.populate(*pairs)
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0

    reset_launch_counts()          # the main path starts here ...
    lat, real_new = [], 0
    with torch.no_grad():
        for batch in batches:
            t = time.perf_counter()
            res = eng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
            real_new += res.big_tokens + res.small_tokens
            if len(res.responses) != len(batch) or not all(
                    isinstance(r, str) for r in res.responses):
                raise AssertionError("handle_batch returned malformed responses")
    launches = launch_counts()     # ... and ends here
    s = eng.stats
    n = n_batches * bsz
    if min(s.exact, s.tweak, s.miss) == 0:
        raise AssertionError(f"not every route was taken: {s}")
    if s.total != n or s.exact + s.tweak + s.miss != n:
        raise AssertionError(f"EngineStats inconsistent: {s}")
    if not s.big_tokens + s.small_tokens <= n * max_new_tokens or real_new != (
            s.big_tokens + s.small_tokens):
        raise AssertionError(f"generated tokens exceed queries x budget: {s}")
    if eng.device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by the serve path: {launches}")
    with torch.no_grad():
        pick = list(eng.bank.text_store.items())[:bsz]
        reuse = prefix_reuse_check(
            eng, [q + " please" for _, (q, _) in pick], [c for _, c in pick], max_new_tokens)
    big, small, _ = model_configs(model)
    row = {"phase": "serve", "model": model, "big": big.name, "small_attention":
           small.attention_impl, "layers": big.num_layers, "d_model": big.d_model,
           "bank_rows": eng.cache_cfg.capacity, "populated": n_pop, "batches": n_batches,
           "batch_size": bsz, "max_new_tokens": max_new_tokens, "calibration": calib,
           "routes": {"exact": s.exact, "tweak": s.tweak, "miss": s.miss},
           "big_tokens": s.big_tokens, "small_tokens": s.small_tokens,
           "big_prompt_tokens": s.big_prompt_tokens,
           "small_prompt_tokens": s.small_prompt_tokens, "cost_ratio": s.cost / s.baseline_cost,
           "batch_ms": lat, "first_batch_ms": lat[0],
           "steady_batch_ms_mean": sum(lat[1:]) / max(len(lat) - 1, 1),
           "setup_s": setup_s, "launches": launches,
           "prefix_reuse": reuse}
    if eng.device.type == "cuda":
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row, launches, eng, spare


def decode_step_timing(eng, seed: int, steps: int = 16):
    """Host enqueue, wall and device time (CUDA events) of one decode step of
    the small model at batch 8 over a 192-token cache."""
    import torch
    model, params = eng.small.model, eng.small.params
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    tokens = torch.randint(5, model.cfg.vocab_size, (8, 160), device=eng.device,
                           generator=gen)
    _, caches = model.prefill(params, {"tokens": tokens}, 160 + steps + 8)
    tok = tokens[:, -1].to(torch.int32)
    for _ in range(2):                                   # warm up
        _, caches = model.decode_step(params, tok, caches)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        _, caches = model.decode_step(params, tok, caches)
    end.record()
    host_enqueue = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, caches)
        torch.cuda.synchronize()
    return {"model": model.cfg.name, "batch": 8, "host_enqueue_ms": host_enqueue,
            "wall_ms": wall, "device_ms": start.elapsed_time(end) / steps,
            "kernels_per_step": sum(r[2] for r in kernel_rows(prof))}


def profile_phase(eng, batch, max_new_tokens: int, seed: int):
    """Where the time goes, on the engine the serve phase left: one decode
    step alone, then one more serve batch under ``torch.profiler``."""
    import torch
    with torch.no_grad():
        step = decode_step_timing(eng, seed)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, meta = eng.handle_batch(batch, max_new_tokens=max_new_tokens,
                                       collect_meta=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiled serve batch recorded no device time")
    routes = {d: sum(m["decision"] == d for m in meta) for d in (0, 1, 2)}
    return {"phase": "profile", "decode_step": step, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "routes_miss_tweak_exact": [routes[0], routes[1], routes[2]],
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for k, us, c in rows[:15]]}


SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:64"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:142"),
    "cosine_topk": ("src/repro_torch/csrc/cosine_topk.cu",
                    "src/repro/kernels/cosine_topk/kernel.py:143"),
}
SUMMARY_CASE = {"flash_attention": "small-suffix-over-prefix",
                "decode_attention": "small-tweak-decode", "cosine_topk": "serve-bank"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core import tweak as tweak_lib
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.tokenizer import HashWordTokenizer

    smi = nvidia_smi()
    resolve_device("cuda")
    build.load_library()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build.build_seconds,
          "device_count": torch.cuda.device_count()})

    prefix_len = len(tweak_lib.tweak_prefix_ids(HashWordTokenizer(128256)))
    checked = kernel_phase(prefix_len, args.seed)
    serve, launches, eng, spare = serve_phase("llama-3.1-8b", torch.device("cuda"),
                                              args.seed, N_BATCHES, MAX_NEW_TOKENS)
    # the profiler only after serving: the serve timings stay free of
    # whatever it leaves attached to the process
    cases = []
    for row, (run, library, reps) in checked:
        row["device_ms"] = device_ms(run, reps)
        row["library_device_ms"] = device_ms(library, reps)
        cases.append(row)
        emit(row)
    emit(serve)
    emit(dict(profile_phase(eng, spare, MAX_NEW_TOKENS, args.seed), nvidia_smi=smi))
    worst = {}
    for c in cases:
        worst[c["name"]] = max(worst.get(c["name"], 0.0), c["max_abs_err"])
    summary = []
    for name, (source, replaces) in SOURCES.items():
        c = next(x for x in cases if x["name"] == name and x["case"] == SUMMARY_CASE[name])
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": worst[name],
                        "ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
