#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TweakLLM on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Prints one JSON object per line:

  env     the card (nvidia-smi name and power limit), torch/CUDA versions, the
          seconds the kernels took to build from ``src/repro_torch/csrc`` and
          each kernel's registers, static shared memory, stack and spill bytes
          from the ptxas log of that build, and its count of tensor-core
          (HMMA/HGMMA), ldmatrix, cp.async and shuffle instructions from
          ``cuobjdump -sass`` (the bf16 flash kernel and every instance of the
          attention-panel body, dense and paged, must have HMMA and
          cp.async, the panel and shortlist-kernel instances and the dh-256
          flash instance no spill bytes,
          and no CUDA-core attention body may be built for bf16), and how
          many clusters of 1..8 blocks of the panel body (dh 128, and dh 256
          at one block a SM) and of the shortlist kernel the card holds at
          once (no fewer than their launch plans assume);
  kernel  one line per Hopper kernel and main-path shape: max |kernel - plain|
          against its tolerance, the kernel's time per call (CUDA events over
          back-to-back calls, ``ms``; and its kernels' device time from the
          profiler, ``device_ms``), the plain version's, one PyTorch library
          call's (a yardstick, never used by the port) and the least time the
          card could take (bytes / 3.35 TB/s or operations / peak rate,
          whichever is larger); a case that keeps every key (non-causal
          flash, a full cross cache) is held to 4 bf16 ulps of its largest
          output and must lie nearer its own form than the one where the zero
          keys padding it to a whole tile take weight, or do not
          (``form_check``); the flash suffix case also holds the suffix
          over the stored prefix bit for bit against the inline prefill, and
          the ``train-backward`` cases (bf16, fp32) time forward + backward
          through the flash autograd wrapper (kernel forward, plain
          backward) against autograd of the plain version and SDPA's; the
          fp32 instances below dh 32 (``small_head_dim_cases``: dense decode
          at dh 24, verify K 4 / K 1, paged decode and paged verify K 4 at
          dh 16 G 2 and G 4, dh 24 G 4 and dh 32 G 2, at the smoke paths'
          and the examples' shapes) are held to 1e-5;
  serve_cli ``python -m repro_torch.launch.serve`` with no arguments (the
          tiny fp32 stack, head dim 16, on the card; run through ``runpy`` in
          this process): exit 0, 200 completions, its kernel launches;
  train   the embedder (MiniLM at full width over the 128,256-token
          vocabulary, 60 steps at batch 16) and the cross-encoder reranker
          (the same width, 120 steps at batch 32) trained on the card as
          ``build_stack`` trains them: seconds, median ms per step, the first
          and last 10-step mean loss (the last must be lower), one parity step
          of the same params and batch on the card and on the CPU, and
          held-out quality before and after (the embedder's mean cosine to a
          duplicate minus to a hard negative, the reranker's accuracy);
  lm_train llama-3.1-8b at full width, depth cut to 4 layers, trained 40
          steps (batch 8 x 128, AdamW lr 1e-3, remat) through
          ``make_train_step``: median step ms, tokens/s, peak memory, flash
          launches a step (forward and the remat recompute), the first and
          last 10-step mean loss (the last must be lower); step 1's batch
          gives every leaf, and every layer's w_qkv and w_o, a gradient; the
          gradients a microbatches-2 step applies (fp32) against the whole
          batch's within 2% of each leaf's largest |g|; the train CLI on its
          default (qwen2.5-3b's smoke config) returns 0 with one flash
          launch a layer a step (its fp32 dh-32 flash shape is a kernel case,
          ``train-cli-default-smoke-fp32``);
  zero_train ``launch.zero_trainer.make_zero_train_step`` on a one-rank NCCL
          group (an in-memory store: no port): llama-3.1-8b at full width, 2
          of 32 layers, batch 8 x 128 as 4 microbatches, 3 steps, one
          all-reduce a step of a flat fp32 bucket (the gradients and the loss);
          losses and every parameter bit for bit equal to 3 steps of
          ``make_train_step(microbatches=4)`` from the same start (kept on the
          host meanwhile); the bytes NCCL is handed each step equal to the
          dry-run's reckoning of the step (``launch.collectives``, on a data
          mesh of two ranks each holding this batch); step ms, peak memory,
          flash launches;
  judge   that trained model as referee: mean log-likelihood of 48 big,
          small and word-shuffled big responses before and after training
          (after: real above shuffled), ms per set, flash launches, two rows
          against an fp32 CPU score (within 0.01), ``debate_batch`` big against small
          (verdict shares sum to 1, mean margin by persona);
  archs   the dense attention variants, the MoE stacks and the recurrent
          stacks at full width, one at a time on an emptied card: qwen2.5-3b
          (QKV bias, 36 layers), h2o-danube-1.8b (sliding window 4,096, 24
          layers), deepseek-coder-33b (8 of 62 layers), nemotron-4-340b
          (squared ReLU, layernorm, 2 of 96 layers), arctic-480b (128
          experts top-2 and a dense residual, 2 of 35 layers),
          qwen3-moe-235b-a22b (128 experts top-8, G 16, 4 of 94 layers),
          mamba2-130m (24 Mamba-2 SSD layers) and recurrentgemma-9b (2
          periods of RG-LRU, RG-LRU, local attention at dh 256 and G 16,
          then two RG-LRU layers: 8 of 38), whisper-tiny (4 encoder and 4
          decoder layers over 1,500 random frames, cross attention decoded
          through the dense decode kernel) and internvl2-26b (12 of 48
          layers, G 6, behind 256 random prefix embeddings), random
          weights: 4 prompts of
          128 tokens, 32 greedy tokens through ``Generator``'s fused decode
          against one teacher-forced forward under the margin rule (for a
          MoE stack over the rows where neither the prefill nor the forward
          dropped a pair), the fused tokens equal to the same steps run one
          by one (ms a step, against the step's weight-read bound), one
          flash launch a layer a prefill and one decode launch a layer a
          step (an attention layer's; none for mamba2; whisper's encoder
          layers one flash, its decoder layers two of each); for danube and
          recurrentgemma also 2 prompts of 64 tokens past the window (4,160
          and 2,112) whose prefill lays out the ring and 64 decode steps
          wrap on through it, held to the forward the same way;
          for a MoE stack layer 0's MoE on the prefill's 512-token group and
          on a 4-token decode group against a literal fp32 transcription of
          the reference's one-hot einsum dispatch (the same kept pairs, 2e-2),
          the dropped pairs; for qwen3-moe and internvl2 (with its prefix)
          every other decode path (``paths_check``: the paged, speculative
          and paged speculative Generator, drafts at overlap 1.0 and 0.5,
          and a paged ``DecodeSession`` plain and speculative over the
          prompts alone), held to the Generator's tokens; for a MoE,
          recurrent or frontend stack the train CLI's smoke run of the id;
  smoke_paths every smoke config (``get_config(id, smoke=True)``, fp32,
          uncut) and the serve CLI's tiny stack's small model, random weights:
          4 prompts of 32 tokens, 16 greedy tokens through ``generate_check``
          (dense decode held to a teacher-forced forward under the margin
          rule); the six paged- and speculation-eligible configs (qwen2.5-3b
          dh 32, deepseek-coder-33b, arctic-480b, qwen3-moe-235b-a22b,
          internvl2-26b dh 16, nemotron-4-340b dh 24) and the tiny small
          model (dh 16, G 2) also paged, speculative and paged speculative
          (k 4, drafts from the dense tokens at overlap 1.0 and 0.5) and
          through a paged ``DecodeSession`` plain and speculative
          (``paths_check``), held to the dense tokens under the margin rule,
          each path's kernel launched, no page leaked;
  examples the port's ``repro_torch.examples`` run as ``python -m`` runs them
          at the reference's defaults: ``quickstart`` (five routes),
          ``serve_e2e`` (120 arrivals, batch 8, 80 pretraining steps: wall
          seconds, losses, routes, hit rate, cost ratio; completed + rejected
          = queries, miss + tweak + exact = rows served, flash and the dense
          decode at dh 24 and 16 launched), ``cache_policy_study`` (the hit
          rate of FIFO, LRU and LFU banks of 96 rows over 500 queries);
  shapes  the reference's assigned input shapes at its per-card batch, one
          case at a time on an emptied card, through
          ``launch.dryrun.run_one(..., device="cuda")``: llama-3.1-8b's
          prefill_32k (B 2 x 32,768) and decode_32k (B 8 from caches filled at
          random, pos 32,768: 32,769 live slots of 33,024), qwen2.5-3b's
          train_4k (B 16 as 4 microbatches of 4 x 4,096, depth as the
          dry-run's one-card plan cuts it) and the long_500k decode (B 1 at
          pos 524,288) of h2o-danube-1.8b, recurrentgemma-9b and mamba2-130m;
          a line each with the plan (batch, microbatches, layers), ms a step,
          ``max_memory_allocated`` against the reckoned peak (under 80 GB),
          kernel launches, the dry-run's collective bytes of the shape on
          the 16 x 16 mesh; a decode takes 8 greedy steps twice from the same
          cache, bitwise equal and finite; then the kernel cases at these
          shapes (``shape_kernel_cases``: the 32k flash held on its first
          and last 128 query rows, whose plain version fits, the 4k flash,
          the 32,769-slot decode and both rings at B 1), rows with thousands
          of keys held to 4 bf16 ulps of their largest output;
  serve   the full-width stack (``build_stack(model="llama-3.1-8b")``, its
          embedder trained): a restored bank of random unit vectors, a few
          hundred populated pairs, then batches of 8 through
          ``TweakLLMEngine.handle_batch`` with exact repeats, one-word edits
          and fresh queries; routing counts, tokens, per-batch latency and
          kernel launches;
  paged   the same traffic through an engine whose generators decode over
          a paged KV pool (16-token pages, the tweak prefix pinned), on the
          serve phase's weights, against a dense engine on the same weights:
          routes, tokens under the margin rule (see ``margin_rule``), batch
          latency, launches, zero leaked pages;
  spec    speculative TWEAK decode (k 4) on cached-response drafts: a TWEAK
          batch over the shared prefix, dense and paged, drafts at overlap
          1.0 / 0.5 / 0.0 against plain decode (tokens, proposed / accepted
          / verify iterations, host syncs, latency), then the paged engine
          with drafts from its ``draft_store``;
  session ``DecodeSession(slots=8)`` on the big model, paged: the inaugural
          cohort against dense greedy decode, join and leave mid-flight,
          zero leaked pages; then ``DecodeSession(slots=8, spec_k=4)``
          (``spec``) with drafts cut from the plain session's own tokens at
          overlap 1.0 / 0.5 / 0.0 (ms, ``spec_stats``, tokens under the
          margin rule, fewer speculating verify blocks than plain steps at
          1.0) and a cohort with drafts joining mid-flight;
  ivf     the serve traffic through an engine whose bank has the IVF index
          (2,048 clusters, 8 probed), on the serve phase's weights and
          restored bank: one k-means rebuild (seconds, spilled rows, largest
          cluster), every valid slot with exactly one live member entry, a
          full probe against the flat kernel, recall@1 at the default probe,
          routes, lookup time per batch flat and IVF, the shortlist kernel's
          launches;
  replicas ``ReplicaGroup.build(2, shared=True)`` on the serve phase's
          generators and restored bank, batch i to replica i % 2: routes as
          in serve, tokens against the dense re-run under the margin rule, a
          MISS of replica 0 an EXACT on replica 1; a ``ReplicaScheduler`` on
          a ``SimClock`` replaying the first 24 queries as a Poisson trace
          over a shared bank and over private banks (completions, per-lane
          dispatches and steals, hit rates); zero leaked KV pages;
  sharded the serve phase's restored bank split into 4 shards of 65,536 rows,
          all on cuda:0: top-k within 1e-5 of the local bank's and the same
          indices, routes as local away from the thresholds, ``cosine_topk``
          4 times a batch, one routing copy a batch, the gathered state equal
          to the local one bit for bit; the ``ivf`` phase's index resharded,
          at a full probe equal to the flat kernel, ``cosine_topk_gather``
          once per shard; ``route_batch`` ms local and sharded;
  cascade the serve traffic with the router cascade on (a band around the
          threshold holding >= 8 of the 48 rows, the trained reranker), on
          the serve phase's weights and restored bank: routes outside the
          band as in serve, stage 2 against a CPU re-run of it, routing
          copies per batch (1, or 2 with UNCERTAIN rows), ``uncertain``,
          ``recovered``, the stage-2 resolve's time;
  baseline the GPTCache baseline (embed, top-k, rerank, verbatim) on a bank
          of 262,144 rows holding the populated pairs: precision and recall
          of ``get`` over a held-out duplicate and hard negative of each;
  analysis the hot-path analyzer on the card: ``analysis.contracts.run_all(
          device="cuda")`` (every registered hot path at the reference's tiny
          buckets, twice), then one more batch of the plan's traffic (8
          queries: 2 EXACT, 3 TWEAK, 3 MISS, screened beforehand by a
          read-only lookup) through the serve engine, and one plain and one
          speculative (k 4) ``Generator`` call, each under the
          TorchFunctionMode sync counter and ``set_sync_debug_mode("warn")``:
          the syncs each method counted, by site, against the budget (1 route
          fetch, +1 with UNCERTAIN rows, +1 a generator call, +1 an insert; 1
          a plain call; ``spec_steps + 2``), the bank's leaves kept in place,
          the batch's wall time with and without the modes (the latter on a
          second batch of the same make-up), its kernel launches;
  profile where the time goes, after the serve run: one small-model decode
          step timed alone (host enqueue, wall and device time), then one
          more serve batch under ``torch.profiler`` with device activity
          (wall time, device-busy share, device time by kernel name), then
          one paged big-model decode of that batch (device-busy ms, the
          paged kernels' share), and the seconds of each part;
  kernels the ported kernels with their launches on the path that runs
          them (serve for the dense kernels, paged, spec, ivf; flash also
          its launches in lm_train, zero_train and judge; flash, dense decode
          and the flat scan also the analysed serve batch's and the
          examples'; flash and the four decode kernels the smoke paths');
  wall    the script's wall time, the seconds before each phase's line
          (``phase_s``: ``kernel_cases`` the cases' checks, ``kernel`` their
          profiled device times, ``wall`` the summary), and how many
          ``device_ms`` profiler sessions were whole and how many lost
          records and were repeated;

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
PAGE = 16                      # KV page size of the paged phases
POOL_PAGES = 256               # pages per paged generator (2 MiB each at full width)
SPEC_K = 4                     # verify block of the speculating phases
CACHE_SHARDS = 4               # shards of the sharded-bank phase, all on cuda:0
# The dense attention variants and the MoE stacks at full width (``archs``):
# (id, layers kept, None for the whole depth).  deepseek-coder-33b keeps 8 of 62 layers (9.4 GB
# of weights) to hold the phase's time; nemotron-4-340b keeps 2 of 96 (33 GB:
# 6.9 GB a layer, 18.9 GB of embedding and untied head; 96 layers need ~680
# GB).
ARCHS = (("qwen2.5-3b", None), ("h2o-danube-1.8b", None), ("deepseek-coder-33b", 8),
         ("nemotron-4-340b", 2), ("arctic-480b", 2), ("qwen3-moe-235b-a22b", 4),
         ("mamba2-130m", None), ("recurrentgemma-9b", 8), ("whisper-tiny", None),
         ("internvl2-26b", 12))
# recurrentgemma-9b keeps 8 of 38 layers (2 periods of RG-LRU, RG-LRU, local
# attention and the 2 remainder RG-LRU layers: every kind of layer and its
# ring) and internvl2-26b 12 of 48 behind its 256 prefix positions: the
# phase's checks hold at any depth, and the cut keeps the script's time
# (at full depth they took 17 and 28 s of the phase's 80 s on a busy host).
# The MoE stacks: arctic-480b keeps 2 of 35 layers (~55.4 GB: 27.2 GB a layer,
# 26.8 GB of it experts; 35 layers need ~954 GB); qwen3-moe-235b-a22b 4 of 94
# (~22.4 GB: 4.98 GB a layer; 94 layers need ~470 GB).  qwen3-moe also runs
# the paged and speculative paths (``paths_check``) at G 16; arctic's
# attention shapes are deepseek-coder-33b's, whose kernel cases stand for it.
MOE_PATHS_ARCH = "qwen3-moe-235b-a22b"
ARCH_KERNEL_CASES_OF = {"arctic-480b": "deepseek-coder-33b-prefill, deepseek-coder-33b-decode "
                                       "(the same shapes: B 4, H 56 / Hk 8, dh 128)",
                        "whisper-tiny": "whisper-encoder, whisper-cross-prefill, "
                                        "whisper-decoder-prefill, whisper-self, whisper-cross, "
                                        "train-cli-whisper-fp32",
                        "internvl2-26b": "internvl2-prefill, internvl2, internvl2-K4 (verify "
                                         "and paged), train-cli-internvl2-fp32"}
# The frontend stacks, whisper-tiny (4 + 4 layers, 1,500 frames; 73 MB) and
# internvl2-26b (12 of 48 layers, 256 prefix positions), take the train CLI's
# random frontend inputs (``launch.train.frontend_inputs``).
ARCH_BATCH, ARCH_PROMPT, ARCH_NEW = 4, 128, 32
# a windowed stack's ring run: rows, tokens of the prompt past the window
# (danube 4,096 + 64, recurrentgemma 2,048 + 64), decode steps
RING = (2, 64, 64)
TRAIN_CLI_ARCH = "qwen2.5-3b"  # the train CLI's default --arch, as the reference's
SERVE_CLI_QUERIES = 200        # the serve CLI's default --queries
REPLICA_TRACE = 24             # queries of the replica scheduler's SimClock replay: the
#                                first 3 serve batches' (all 48 took 17-30 s a bank)
# ``smoke_paths``: every smoke config (``configs.get_config(id, smoke=True)``,
# fp32, uncut) and the serve CLI's tiny stack's small model, random weights:
# prompts x tokens, greedy tokens
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 4, 32, 16
# ``examples``: the port's counterparts of the reference's examples/*.py, run
# as ``python -m`` runs them at the reference's defaults (serve_e2e's are
# --queries 120 --batch 8 --steps 80)
EXAMPLES = ("quickstart", "serve_e2e", "cache_policy_study")


PHASE_S = {}                   # seconds spent before each phase's line (the wall line)
_LAST_MARK = [time.perf_counter()]


def mark(name: str) -> None:
    """Add the seconds since the last mark to ``PHASE_S[name]``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - _LAST_MARK[0]
    _LAST_MARK[0] = now


def emit(obj) -> None:
    if "phase" in obj:
        mark(obj["phase"])
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


# torch.profiler drops a kernel record whose span, on the host clock it is
# converted to, falls outside the session ("Out-of-range" in Kineto's log),
# and the card's records sometimes land up to ~2 ms before their own launch
# ("CPU GPU out-of-order").  Once the process has run autograd on the card,
# Kineto counts the first records of every session out of range: 2-3 of them
# after training, up to 11 after the replica and sharded phases (an H100,
# torch 2.11).  So a session waits before its first launch and after its
# last, and opens with 32 sentinel kernels (``torch.cuda._sleep``, left out of
# the rows; ``sentinels_seen_min`` on the wall line) and a sync.
PROFILER_LEAD_S = 0.1
PROFILER_SENTINELS = 32
PROFILER_SENTINEL_CYCLES = 20_000  # ~10 us each: the sentinels span a few hundred us
PROFILER_SENTINEL = "spin_kernel"
PROFILER_ATTEMPTS = 5
profiler_sessions = {"whole": 0, "short": 0, "sentinels_seen_min": PROFILER_SENTINELS}


def device_ms(fn, reps: int = 10, split: bool = False):
    """Device time of ``fn`` per call: the summed durations of the GPU kernels
    it launches, from ``torch.profiler``.  For a kernel of a few microseconds
    the CUDA-event time of back-to-back calls (``time_ms``) is the host's
    launch rate instead; this is the card's own time.  Every call launches
    the same kernels, so a session in which a kernel's count is not a whole
    multiple of ``reps`` lost records: it is profiled again, up to
    PROFILER_ATTEMPTS sessions, and fails if none is whole.  ``split`` also
    returns {kernel name: (ms per call, launches per call)}."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_LEAD_S)
            for _ in range(PROFILER_SENTINELS):
                torch.cuda._sleep(PROFILER_SENTINEL_CYCLES)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_LEAD_S)
        rows = kernel_rows(prof)
        seen = sum(c for k, _, c in rows if PROFILER_SENTINEL in k)
        profiler_sessions["sentinels_seen_min"] = min(profiler_sessions["sentinels_seen_min"],
                                                      seen)
        rows = [r for r in rows if PROFILER_SENTINEL not in r[0]]
        if rows and all(c % reps == 0 for _, _, c in rows):
            profiler_sessions["whole"] += 1
            break
        profiler_sessions["short"] += 1
    else:
        raise AssertionError(f"the profiler lost kernel records in {PROFILER_ATTEMPTS} "
                             f"sessions (sentinels seen: {seen} of {PROFILER_SENTINELS}): "
                             f"{rows}")
    us = sum(r[1] for r in rows)
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    if not split:
        return us / 1e3 / reps
    return us / 1e3 / reps, {k[:60]: (t / 1e3 / reps, c / reps) for k, t, c in rows}


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


MANY_KEYS = 1024   # a decode row over this many keys has |out| of a few thousandths


def every_key_tol(want) -> float:
    """The bf16 limit of a case that keeps every key (non-causal flash, a
    decode whose cache is full): its output is a mean over all of them, small
    at 1,500 keys (max |out| ~0.2), so the limit follows its size: 4 bf16
    ulps of max |want|, and at most the usual 2e-2."""
    import math
    top = want.abs().max().item()
    return min(2e-2, 4 * 2.0 ** (math.floor(math.log2(top)) - 7)) if top > 0 else 2e-2


def form_check(name: str, got, want, other) -> dict:
    """The kernel's output must lie nearer the function it computes than the
    other form of the same case (the zero keys that pad the keys to a whole
    tile taking weight, or not): L2 distance to ``want`` below half the
    distance between the two forms.  A padding fault shifts every element by
    ~1.4% of its size at 1,500 keys, below a max-abs limit but not below
    this one."""
    import torch
    err = torch.linalg.vector_norm(got.float() - want).item()
    gap = torch.linalg.vector_norm(want - other).item()
    if not err < 0.5 * gap:
        raise AssertionError(f"{name}: L2 distance {err} to its form is not below half the "
                             f"{gap} between the padded and unpadded forms")
    return {"form_l2_err": err, "form_l2_gap": gap}


def wave_clusters(build) -> dict:
    """{"nt1", "nt2": clusters of 1..8 blocks of the bf16 attention-panel
    body (dh 128, the main shapes' shared memory) that the card holds at
    once; "dh256_nt1", "dh256_nt2": the same for the dh-256 instance at
    recurrentgemma's ring shape, one block a SM}; fails where the card holds
    fewer than the launch plan's ``WAVE_CLUSTERS`` (``WAVE_CLUSTERS_ONE_A_SM``)
    assumes, since a call would then run a second wave."""
    import ctypes
    import torch
    from repro_torch.kernels.decode_attention.ops import (WAVE_CLUSTERS,
                                                          WAVE_CLUSTERS_ONE_A_SM, launch_plan)
    lib, out = build.load_library(), {}
    for dh, label, entry, table, plan in (
            (128, "", "panel_mma_wave_clusters", WAVE_CLUSTERS,
             launch_plan(8, 1, 206, 8, 4, 128, torch.bfloat16)),
            (256, "dh256_", "panel_mma_wave_clusters_dh256", WAVE_CLUSTERS_ONE_A_SM,
             launch_plan(ARCH_BATCH, 1, 2048, 1, 16, 256, torch.bfloat16))):
        for nt in (1, 2):
            got = []
            for splits in range(1, len(table) + 1):
                n = ctypes.c_int(0)
                build.check(getattr(lib, entry)(nt, splits, plan.smem_bytes, ctypes.byref(n)),
                            entry)
                got.append(n.value)
            if any(g < w for g, w in zip(got, table)):
                raise AssertionError(f"the card holds {got} clusters of the dh-{dh} instance "
                                     f"at NT {nt}, fewer than the launch plan's {list(table)}")
            out[f"{label}nt{nt}"] = got
    return out


def gather_wave_clusters(build) -> list:
    """Clusters of 1..8 blocks of the shortlist kernel that the card holds at
    once, the least over its k instances; fails where the card holds fewer
    than ``cosine_topk.ops.GATHER_WAVE_CLUSTERS`` assumes."""
    import ctypes
    from repro_torch.kernels.cosine_topk.ops import GATHER_WAVE_CLUSTERS, MAX_K
    lib, got = build.load_library(), []
    for cluster in range(1, len(GATHER_WAVE_CLUSTERS) + 1):
        least = None
        for k in range(1, MAX_K + 1):
            n = ctypes.c_int(0)
            build.check(lib.cosine_topk_gather_wave_clusters(k, cluster, ctypes.byref(n)),
                        "cosine_topk_gather_wave_clusters")
            least = n.value if least is None else min(least, n.value)
        got.append(least)
    if any(g < w for g, w in zip(got, GATHER_WAVE_CLUSTERS)):
        raise AssertionError(f"the card holds {got} shortlist-kernel clusters, fewer than the "
                             f"gather plan's {list(GATHER_WAVE_CLUSTERS)}")
    return got


def panel_plan(name: str, label: str, plan, dtype) -> dict:
    """The cut of an attention-panel call (``decode_attention.ops.
    launch_plan``) as the kernel line reports it: bf16 must take the
    tensor-core route ("mma", one launch), fp32 the CUDA-core one ("panel",
    its splits merged by a second launch)."""
    import torch
    want = "panel" if dtype == torch.float32 else "mma"
    if plan.route != want:
        raise AssertionError(f"{name}[{label}]: route {plan.route}, not {want} for {dtype}")
    return {"route": plan.route, "grid": list(plan.grid), "chunk": plan.chunk,
            "splits": plan.splits, "kq_panel": plan.kq_panel, "smem_bytes": plan.smem_bytes}


# ------------------------------------------------------------------ kernels

def flash_case(label, b, sq, prefix, h, hk, dh, block, impl, gen, dtype="bfloat16",
               window=0, causal=True, sk=None):
    """The prefill kernel at one main-path shape: queries at [prefix,
    prefix+sq) over keys [0, prefix+sq), bf16 (or fp32, the CUDA-core
    body, as the train CLI's smoke config runs it), within ``window``
    positions when it is > 0 (a sliding-window stack's prefill).  With
    ``causal`` False, every key is kept: ``sk`` keys (``sq`` by default,
    whisper's encoder, positions from 0), or, when ``sk`` differs from
    ``sq``, a cross attention's, every position 0."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda")
    sk = sk or prefix + sq
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, h, dh, device=dev, generator=gen, dtype=dt)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=gen, dtype=dt)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=gen, dtype=dt)
    q_pos = torch.arange(prefix, prefix + sq, device=dev, dtype=torch.int32)
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32)
    if sk != prefix + sq:      # cross attention: no positions
        q_pos, k_pos = torch.zeros_like(q_pos), torch.zeros_like(k_pos)
    q_pos, k_pos = q_pos.expand(b, sq).contiguous(), k_pos.expand(b, sk).contiguous()
    run = lambda: ops.flash_attention(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                      block_q=block, block_k=block, impl=impl)
    out = run()
    if impl == "naive":
        plain = lambda: ref.attend_naive(q, k, v, q_pos, k_pos, causal, window)
        want = ref.attend_naive(q.float(), k.float(), v.float(), q_pos, k_pos, causal, window)
    else:
        plain = lambda: ref.attend_blockwise(q, k, v, q_pos, k_pos, causal, window, block,
                                             block)
        want = ref.attend_blockwise(q.float(), k.float(), v.float(), q_pos, k_pos, causal,
                                    window, block, block)
    err = (out.float() - want).abs().max().item()
    # bf16 output (ulp 2^-8 near 1) against an fp32 evaluation; fp32 against
    # fp32 differs only in the order of the sums
    tol = 1e-5 if dt == torch.float32 else 2e-2 if causal else every_key_tol(want)
    check(f"flash_attention[{label}]", err, tol)
    form = {}
    if not causal and sk % block:   # the padded zero keys take weight under xla_flash only
        f = (q.float(), k.float(), v.float(), q_pos, k_pos, causal, window)
        other = (ref.attend_blockwise(*f, block, block) if impl == "naive"
                 else ref.attend_naive(*f))
        form = form_check(f"flash_attention[{label}]", out, want, other)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (k_pos[0][None, :] <= q_pos[0][:, None]) | (not causal)
    if window:
        mask &= k_pos[0][None, :] > q_pos[0][:, None] - window
    if not causal:   # every key kept: SDPA without a mask
        kind = "sdpa, no mask"
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    elif prefix or window:   # the mask is not SDPA's own causal one
        kind = "sdpa, explicit mask"
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
    else:           # positions from 0 on both sides: SDPA's causal path is the same function
        kind = "sdpa, is_causal"
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True)
    pairs = b * h * int(mask.sum().item())          # allowed (query, key) pairs
    moved = q.element_size() * (q.numel() * 2 + k.numel() + v.numel()) + 4 * (sq + sk) * b
    bms, by = bound(moved, 4.0 * pairs * dh, "fp32" if dt == torch.float32 else "bf16")
    row = {"phase": "kernel", "name": "flash_attention", "case": label,
           "shape": {"B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "dh": dh,
                     "block": block, "impl": impl, "dtype": dtype, "window": window,
                     "causal": causal},
           "library": kind,
           "max_abs_err": err, "tolerance": tol, "ms": time_ms(run),
           "plain_ms": time_ms(plain, reps=5), "library_ms": time_ms(library),
           "bound_ms": bms, "bound_by": by, **form}
    if prefix:
        row["suffix_bitwise_equal"] = suffix_bitwise_check(q, k, v, prefix, block, impl)
    return row, (run, library, 10)


def flash_rows_case(label, b, s, h, hk, dh, block, gen, rows: int = 128, reps: int = 3):
    """The prefill kernel on a causal prompt of ``s`` tokens from position 0
    (bf16, "xla_flash" as the model runs it past 2,048), held on a slice of
    its rows: the first and the last ``rows`` queries of each row over
    every key, since an output row depends on its own query alone and the
    plain version of the whole (B, H, S, S) fp32 scores may not fit the
    card.  Each slice is held to 4 bf16 ulps of its own largest output: the
    last rows average thousands of keys to a few thousandths.  ``plain_ms``
    times the plain version on the last ``rows`` queries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda")
    q = torch.randn(b, s, h, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn(b, s, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn(b, s, hk, dh, device=dev, generator=gen, dtype=torch.bfloat16)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    run = lambda: ops.flash_attention(q, k, v, pos, pos, causal=True, window=0,
                                      block_q=block, block_k=block, impl="xla_flash")
    out = run()
    errs, tols = {}, {}
    for part, sl in (("first", slice(0, rows)), ("last", slice(s - rows, s))):
        want = ref.attend_naive(q[:, sl].float(), k.float(), v.float(), pos[:, sl], pos,
                                True, 0)
        errs[part] = (out[:, sl].float() - want).abs().max().item()
        tols[part] = every_key_tol(want)
        check(f"flash_attention[{label}] {part} {rows} rows", errs[part], tols[part])
        del want
    del out
    last = slice(s - rows, s)
    plain = lambda: ref.attend_blockwise(q[:, last], k, v, pos[:, last], pos, True, 0, block,
                                         block)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True)
    pairs = b * h * s * (s + 1) // 2
    moved = q.element_size() * (q.numel() * 2 + k.numel() + v.numel()) + 4 * 2 * s * b
    bms, by = bound(moved, 4.0 * pairs * dh, "bf16")
    row = {"phase": "kernel", "name": "flash_attention", "case": label,
           "shape": {"B": b, "Sq": s, "Sk": s, "H": h, "Hk": hk, "dh": dh, "block": block,
                     "impl": "xla_flash", "dtype": "bfloat16", "window": 0, "causal": True},
           "library": "sdpa, is_causal", "checked_rows": {"first": rows, "last": rows},
           "max_abs_err": max(errs.values()), "tolerance": min(tols.values()),
           "slice_err": errs, "slice_tol": tols,
           "ms": time_ms(run, reps=reps, warmup=1),
           "plain_ms": time_ms(plain, reps=reps, warmup=1), "plain_rows": rows,
           "library_ms": time_ms(library, reps=reps, warmup=1),
           "bound_ms": bms, "bound_by": by}
    return row, (run, library, reps)


def suffix_bitwise_check(q, k, v, prefix, block, impl) -> bool:
    """The TWEAK suffix over a stored prefix against the inline prefill of
    the whole prompt: queries [P, P+S) over keys [0, P+S) must give bit for
    bit the last S rows of queries [0, P+S) over the same K/V.  The prefix
    rows' queries are drawn here; the suffix rows are the case's own."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    gen = torch.Generator(device=q.device).manual_seed(sk)
    head = torch.randn(b, prefix, h, dh, device=q.device, generator=gen, dtype=q.dtype)
    q_full = torch.cat([head, q], dim=1).contiguous()
    pos = torch.arange(sk, device=q.device, dtype=torch.int32).expand(b, sk).contiguous()
    run = lambda qq, qp: ops.flash_attention(qq, k, v, qp, pos, causal=True, window=0,
                                             block_q=block, block_k=block, impl=impl)
    full = run(q_full, pos)
    suffix = run(q, pos[:, prefix:].contiguous())
    if not torch.equal(suffix, full[:, prefix:]):
        worst = (suffix.float() - full[:, prefix:].float()).abs().max().item()
        raise AssertionError("flash_attention: the suffix over the stored prefix differs "
                             f"from the inline prefill (max abs {worst})")
    return True


def flash_backward_case(label, b, s, h, hk, dh, dtype, gen):
    """The flash kernel inside the differentiable wrapper, as the LM trains
    it (causal from position 0, impl "naive"): forward and backward through
    the wrapper (the kernel's forward, the plain backward of
    ``ref.attend_grads``) against autograd of the plain version on fp32
    copies.  Tolerances: the output as the kernel's (fp32 1e-5, bf16 2e-2);
    each gradient within 1e-4 (fp32) or 2e-2 (bf16) of its largest |g|.
    Times forward + backward; SDPA with ``is_causal`` is the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda")
    q = torch.randn(b, s, h, dh, device=dev, generator=gen).to(dtype).requires_grad_()
    k, v = (torch.randn(b, s, hk, dh, device=dev, generator=gen).to(dtype).requires_grad_()
            for _ in range(2))
    d_out = torch.randn(b, s, h, dh, device=dev, generator=gen).to(dtype)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()

    def run():
        out = ops.flash_attention(q, k, v, pos, pos, causal=True, window=0, block_q=s,
                                  block_k=s, impl="naive")
        return (out,) + torch.autograd.grad(out, (q, k, v), d_out)

    def plain():
        out = ref.attend_naive(q, k, v, pos, pos, True, 0)
        return torch.autograd.grad(out, (q, k, v), d_out)

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dt = d_out.transpose(1, 2).contiguous()

    def library():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dt)

    before = ops.launches
    got = run()
    if ops.launches != before + 1:
        raise AssertionError(f"flash_attention[{label}]: {ops.launches - before} launches")
    f = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want_out = ref.attend_naive(*f, pos, pos, True, 0)
    want = (want_out,) + torch.autograd.grad(want_out, f, d_out.float())
    fp32 = dtype == torch.float32
    tol, grad_rel = (1e-5, 1e-4) if fp32 else (2e-2, 2e-2)
    err = (got[0].detach().float() - want[0].detach()).abs().max().item()
    check(f"flash_attention[{label}]", err, tol)
    grad_err, grad_tol = {}, {}
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        grad_err[name] = (a.float() - w).abs().max().item()
        grad_tol[name] = grad_rel * w.abs().max().item()
        check(f"flash_attention[{label}].{name}", grad_err[name], grad_tol[name])
    elt = q.element_size()
    moved = elt * (4 * q.numel() + 4 * k.numel())     # q, k, v, dO read; o, dq, dk, dv written
    fwd_flops = 4.0 * b * h * s * s * dh / 2
    bms, by = bound(moved, 3.5 * fwd_flops, "fp32" if fp32 else "bf16")
    row = {"phase": "kernel", "name": "flash_attention", "case": label,
           "shape": {"B": b, "Sq": s, "Sk": s, "H": h, "Hk": hk, "dh": dh, "impl": "naive",
                     "dtype": str(dtype).removeprefix("torch."), "causal_from": 0},
           "timed": "forward + backward through the autograd wrapper (kernel forward, "
                    "plain backward)",
           "library": "sdpa, is_causal, forward + backward",
           "max_abs_err": err, "tolerance": tol, "grad_max_abs_err": grad_err,
           "grad_tolerance": grad_tol, "ms": time_ms(run, reps=10),
           "plain_ms": time_ms(plain, reps=5), "library_ms": time_ms(library, reps=10),
           "bound_ms": bms, "bound_by": by, "bound_flops": 3.5 * fwd_flops,
           "bound_bytes": moved}
    return row, (run, library, 5)


def decode_case(label, b, h, hk, dh, t, cache_len, layers, gen, dtype="bfloat16"):
    """The decode kernel at one main-path shape, bf16 (or fp32, the CUDA-core
    body, as the serve CLI's tiny stack runs it).  The timed loop walks
    ``layers`` distinct caches, as a decode step walks its layers, so each
    launch finds its K/V outside the 50 MB L2, as the serve path does."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    q = torch.randn(b, h, dh, device=dev, generator=gen, dtype=dt)
    ks = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=dt)
          for _ in range(layers)]
    vs = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=dt)
          for _ in range(layers)]
    lens = torch.full((b,), cache_len, device=dev, dtype=torch.int32)
    out = ops.decode_attention(q, ks[0], vs[0], lens)
    want = ref.decode_attention_ref(q.float(), ks[0].float(), vs[0].float(), lens)
    err = (out.float() - want).abs().max().item()
    full = cache_len == t       # every slot kept: only the bound T masks the last tile
    many = full or cache_len >= MANY_KEYS
    tol = 1e-5 if dt == torch.float32 else every_key_tol(want) if many else 2e-2
    check(f"decode_attention[{label}]", err, tol)
    form = {}
    if full and t % ops.TILE:    # the other form: zero slots padding T to a whole tile kept
        pad = ops.TILE - t % ops.TILE
        kp, vp = (F.pad(x[0].float(), (0, 0, 0, 0, 0, pad)) for x in (ks, vs))
        other = ref.decode_attention_ref(q.float(), kp, vp, lens + pad)
        form = form_check(f"decode_attention[{label}]", out, want, other)
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

    elt = q.element_size()
    moved = 2 * elt * b * cache_len * hk * dh + 2 * elt * q.numel() + 4 * b
    fp32 = dt == torch.float32
    bms, by = bound(moved, 4.0 * b * h * cache_len * dh, "fp32" if fp32 else "bf16")
    plan = panel_plan("decode_attention", label, ops.launch_plan(b, 1, t, hk, h // hk, dh, dt),
                      dt)
    return {"phase": "kernel", "name": "decode_attention", "case": label,
            "shape": {"B": b, "H": h, "Hk": hk, "dh": dh, "T": t, "cache_len": cache_len,
                      **plan, "dtype": dtype},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run, reps=layers),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library, reps=layers),
            "bound_ms": bms, "bound_by": by, **form}, (run, library, layers)


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


def gather_case(label, b, n, nprobe, bucket, d, k, sets, gen):
    """The IVF shortlist kernel at the probe's shape, fp32: M = nprobe x
    bucket candidate positions per query, each probed cluster's bucket filled
    3/8 to 5/8 with members, -1 padding behind them, and 5% of members stale,
    so about half the candidates are live.  The timed loop walks ``sets`` distinct
    candidate lists, so the live rows (12.6 MB per list at M 2,048) come from
    device memory, not from the 50 MB L2.  The first list holds the corner
    cases: two tied candidates (the lower position must win), a row listed
    twice, and a query with fewer than k live candidates."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref
    dev = gen.device
    m = nprobe * bucket
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=gen), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=gen), dim=-1)
    lists = []
    for _ in range(sets):
        idx = torch.randint(0, n, (b, m), device=dev, generator=gen, dtype=torch.int32)
        fill = torch.randint(3 * bucket // 8, 5 * bucket // 8 + 1, (b, nprobe, 1), device=dev,
                             generator=gen)
        pos = torch.arange(bucket, device=dev)[None, None, :]
        idx = torch.where(pos < fill, idx.view(b, -1, bucket), -1).view(b, m).contiguous()
        valid = (torch.rand(b, m, device=dev, generator=gen) < 0.95) & (idx >= 0)
        lists.append((idx, valid))
    idx, valid = lists[0]
    ra, rb, rd = 11, 7, 5
    db[ra] = q[0]                        # a tie at score 1: ra at position 3 ...
    db[rb] = q[0]                        # ... before rb at position 9
    db[rd] = q[2]                        # rd listed twice, at positions 0 and 1
    idx[0, 3], idx[0, 9], idx[2, 0], idx[2, 1] = ra, rb, rd, rd
    valid[0, 3] = valid[0, 9] = valid[2, 0] = valid[2, 1] = True
    valid[1] = False
    valid[1, :2] = idx[1, :2] >= 0       # query 1: fewer live candidates than k
    live = [v & (i >= 0) for i, v in lists]
    plan = ops.gather_plan(b, m, d, k)
    s, i = ops.cosine_topk_gather(q, db, idx, valid, k=k)
    s_ref, i_ref = ref.cosine_topk_gather_ref(q, db[idx.clamp(min=0).long()], idx, live[0], k)
    fin = torch.isfinite(s_ref)
    if not torch.equal(torch.isfinite(s), fin) or not bool((i[~fin] == -1).all()):
        raise AssertionError(f"cosine_topk_gather[{label}]: empty slots differ: {i}")
    err = (s[fin] - s_ref[fin]).abs().max().item()
    tol = 1e-5
    check(f"cosine_topk_gather[{label}]", err, tol)
    gap = torch.full_like(s_ref, float("inf"))
    d_ = torch.diff(torch.where(fin, s_ref, 1e9), dim=1).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
    sure = fin & (gap > tol)
    if not torch.equal(i[sure], i_ref[sure]):
        raise AssertionError(f"cosine_topk_gather[{label}]: indices differ from the plain "
                             "version")
    if i[0, :2].tolist() != [ra, rb] or i[2, :2].tolist() != [rd, rd]:
        raise AssertionError(f"cosine_topk_gather[{label}]: tie or repeat misplaced: {i[:3]}")
    step = [0]

    def pick():
        j = step[0] % sets
        step[0] += 1
        return lists[j][0], lists[j][1], live[j]

    def run():
        ix, v, _ = pick()
        return ops.cosine_topk_gather(q, db, ix, v, k=k)

    def library():
        ix, _, lv = pick()
        sc = torch.einsum("bd,bmd->bm", q, db[ix.clamp(min=0).long()])
        return torch.topk(torch.where(lv, sc, -torch.inf), k, dim=1)

    plain = lambda: ref.cosine_topk_gather_ref(q, db[idx.clamp(min=0).long()], idx, live[0], k)
    n_live = sum(int(x.sum().item()) for x in live) / sets
    moved = 4 * n_live * d + 5 * b * m + 4 * b * d + 8 * b * k   # live rows, index + mask
    bms, by = bound(moved, 2.0 * n_live * d, "fp32")
    return {"phase": "kernel", "name": "cosine_topk_gather", "case": label,
            "shape": {"B": b, "N": n, "M": m, "nprobe": nprobe, "bucket": bucket, "D": d,
                      "k": k, "live_per_list": n_live, "lists": sets, "dtype": "float32"},
            "plan": {"grid": list(plan.grid), "cluster": plan.cluster, "block_m": plan.block_m,
                     "rounds": plan.rounds, "rows_in_flight": plan.rows_in_flight,
                     "row_passes": plan.row_passes, "smem_bytes": plan.smem_bytes},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run, reps=4 * sets),
            "plain_ms": time_ms(plain, reps=5), "library_ms": time_ms(library, reps=sets),
            "library": "yardstick: topk(where(live, einsum(q, db[cand_idx]), -inf))",
            "bound_ms": bms, "bound_by": by}, (run, library, sets)


def block_case(label, b, kq, h, hk, dh, t, cache_len, layers, gen, dtype="bfloat16"):
    """The dense q-block (verify) kernel at a main-path shape, bf16 (or fp32,
    the CUDA-core panel body, as the smoke configs and tiny stacks run it):
    K queries whose keys sit at slots ``cache_len + i``; the timed loop walks
    ``layers`` distinct caches, as a verify step walks its layers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    q = torch.randn(b, kq, h, dh, device=dev, generator=gen, dtype=dt)
    ks = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=dt)
          for _ in range(layers)]
    vs = [torch.randn(b, t, hk, dh, device=dev, generator=gen, dtype=dt)
          for _ in range(layers)]
    lens = torch.full((b,), cache_len, device=dev, dtype=torch.int32)
    out = ops.decode_attention_block(q, ks[0], vs[0], lens)
    want = ref.decode_attention_block_ref(q.float(), ks[0].float(), vs[0].float(), lens)
    err = (out.float() - want).abs().max().item()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    check(f"decode_attention_block[{label}]", err, tol)
    step = [0]

    def run():
        j = step[0] % layers
        step[0] += 1
        return ops.decode_attention_block(q, ks[j], vs[j], lens)

    plain = lambda: ref.decode_attention_block_ref(q, ks[0], vs[0], lens)
    limit = lens[:, None] + torch.arange(kq, device=dev)[None, :] + 1          # (B,K)
    mask = (torch.arange(t, device=dev)[None, None, :] < limit[:, :, None])[:, None]
    qt = q.transpose(1, 2).contiguous()
    kts = [x.transpose(1, 2).contiguous() for x in ks]
    vts = [x.transpose(1, 2).contiguous() for x in vs]

    def library():
        j = step[0] % layers
        step[0] += 1
        return F.scaled_dot_product_attention(qt, kts[j], vts[j], attn_mask=mask,
                                              enable_gqa=True)

    visible = int(limit.sum().item())             # (row, query, slot) pairs kept
    elt = q.element_size()
    moved = 2 * elt * b * (cache_len + kq) * hk * dh + 2 * elt * q.numel() + 4 * b
    bms, by = bound(moved, 4.0 * h * dh * visible, "fp32" if dt == torch.float32 else "bf16")
    plan = panel_plan("decode_attention_block", label,
                      ops.launch_plan(b, kq, t, hk, h // hk, dh, dt), dt)
    return {"phase": "kernel", "name": "decode_attention_block", "case": label,
            "shape": {"B": b, "K": kq, "H": h, "Hk": hk, "dh": dh, "T": t,
                      "cache_len": cache_len, **plan, "dtype": dtype},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run, reps=layers),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library, reps=layers),
            "library": "scaled_dot_product_attention with a (B,1,K,T) mask",
            "bound_ms": bms, "bound_by": by}, (run, library, layers)


def paged_case(label, b, kq, h, hk, dh, page, cap, length, prefix_len, layers, gen,
               block: bool, dtype="bfloat16"):
    """A paged kernel at a main-path shape, bf16 (or fp32, the CUDA-core
    panel body, as the smoke configs and tiny stacks run it): a pool per layer whose first
    ``prefix_len // page`` pages hold the pinned tweak prefix shared by every
    row, private pages behind them, and a last row parked on the TRASH page
    with no valid slot.  Rows hold positions ``[0, length)`` (and the block's
    K more).  The single-token kernel (``block=False``) takes query 0.  The
    yardstick is SDPA over a dense cache gathered beforehand (no single
    PyTorch call reads pages)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import launch_plan
    from repro_torch.kernels.paged_attention import ops, ref
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    npg = -(-cap // page)
    n_pin = prefix_len // page
    pages = n_pin + b * (npg - n_pin)
    kps = [torch.randn(pages + 1, page, hk, dh, device=dev, generator=gen, dtype=dt)
           for _ in range(layers)]
    vps = [torch.randn(pages + 1, page, hk, dh, device=dev, generator=gen, dtype=dt)
           for _ in range(layers)]
    private = torch.randperm(pages - n_pin, device=dev, generator=gen) + n_pin
    tbl = torch.cat([torch.arange(n_pin, device=dev).expand(b, n_pin),
                     private.view(b, npg - n_pin)], 1).to(torch.int32)
    tbl[-1] = pages                                          # the TRASH row
    tbl = tbl.contiguous()
    filled = length + (kq if block else 0)
    slots = torch.arange(cap, device=dev, dtype=torch.int32)[None, :].expand(b, cap)
    sp = torch.where(slots < filled, slots, -1).to(torch.int32)
    sp[-1] = -1
    sp = sp.contiguous()
    qpos = torch.full((b,), length, device=dev, dtype=torch.int32)
    q = torch.randn(b, kq, h, dh, device=dev, generator=gen, dtype=dt)
    q1 = q[:, 0].contiguous()
    step = [0]
    if block:
        call = lambda j: ops.paged_decode_attention_block(q, kps[j], vps[j], tbl, sp, qpos)
        plain = lambda: ref.paged_decode_attention_block_ref(q, kps[0], vps[0], tbl, sp, qpos)
        want = ref.paged_decode_attention_block_ref(q.float(), kps[0].float(), vps[0].float(),
                                                    tbl, sp, qpos)
        limit = qpos[:, None] + torch.arange(kq, device=dev)[None, :]           # (B,K)
    else:
        call = lambda j: ops.paged_decode_attention(q1, kps[j], vps[j], tbl, sp)
        plain = lambda: ref.paged_decode_attention_ref(q1, kps[0], vps[0], tbl, sp)
        want = ref.paged_decode_attention_ref(q1.float(), kps[0].float(), vps[0].float(),
                                              tbl, sp)
        limit = torch.full((b, 1), 2 ** 30, device=dev)
    out = call(0)
    torch.cuda.synchronize()
    name = "paged_decode_attention_block" if block else "paged_decode_attention"
    plan = panel_plan(name, label, launch_plan(b, kq if block else 1, cap, hk, h // hk, dh, dt),
                      dt)
    if out[-1].float().abs().max().item() != 0:      # also catches NaN
        raise AssertionError(f"{name}[{label}]: the TRASH row is not 0")
    err = (out[:-1].float() - want[:-1]).abs().max().item()   # rows with a valid slot
    tol = 1e-5 if dt == torch.float32 else 2e-2
    check(f"{name}[{label}]", err, tol)

    def run():
        j = step[0] % layers
        step[0] += 1
        return call(j)

    kg = [ref.gather_pages(x, tbl, cap).transpose(1, 2).contiguous() for x in kps]
    vg = [ref.gather_pages(x, tbl, cap).transpose(1, 2).contiguous() for x in vps]
    keep = (sp[:, None, :] >= 0) & (sp[:, None, :] <= limit[:, :, None])       # (B,Kq,cap)
    keep[-1] = True                          # SDPA needs a key per row; TRASH is discarded
    qt = (q if block else q[:, :1]).transpose(1, 2).contiguous()

    def library():
        j = step[0] % layers
        step[0] += 1
        return F.scaled_dot_product_attention(qt, kg[j], vg[j], attn_mask=keep[:, None],
                                              enable_gqa=True)

    valid = int((sp >= 0).sum().item())      # slots read once for all queries
    pairs = int(((sp[:, None, :] >= 0) & (sp[:, None, :] <= limit[:, :, None])).sum().item())
    nq = kq if block else 1
    elt = q.element_size()
    moved = (2 * elt * valid * hk * dh + 2 * elt * b * nq * h * dh + 4 * tbl.numel()
             + 4 * sp.numel() + (4 * b if block else 0))
    bms, by = bound(moved, 4.0 * h * dh * pairs, "fp32" if dt == torch.float32 else "bf16")
    return {"phase": "kernel", "name": name, "case": label,
            "shape": {"B": b, "K": nq, "H": h, "Hk": hk, "dh": dh, "page": page, "cap": cap,
                      "pages": pages, "pinned_pages": n_pin, "valid_slots": valid,
                      **plan, "dtype": dtype},
            "max_abs_err": err, "tolerance": tol, "ms": time_ms(run, reps=layers),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library, reps=layers),
            "library": "yardstick: scaled_dot_product_attention over a dense cache "
                       "gathered from the pages beforehand",
            "bound_ms": bms, "bound_by": by}, (run, library, layers)


def kernel_phase(prefix_len: int, seed: int):
    """(kernel line, (kernel call, library call, profiled calls)) per case."""
    import torch
    from repro_torch.configs import llama31_8b
    from repro_torch.launch.serve import LLAMA_CAPACITY, LLAMA_FLASH_BLOCK
    cfg, smoke = llama31_8b.CONFIG, llama31_8b.SMOKE_CONFIG
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # a TWEAK row: prefix + a 128-token suffix bucket + 33, mid-decode
    tweak_cap, tweak_len = prefix_len + 128 + 33, prefix_len + 128 + 16
    return [
        flash_case("small-suffix-over-prefix", 8, 128, prefix_len, h, hk, dh,
                   LLAMA_FLASH_BLOCK, "xla_flash", gen),
        flash_case("big-miss-prefill", 8, 64, 0, h, hk, dh, cfg.flash_block_k, "naive", gen),
        # llama-3.1-8b's smoke config (fp32, dh 16): the train CLI's --arch llama-3.1-8b,
        # and the serve CLI's tiny stack's head dim
        flash_case("train-cli-smoke-fp32", LM_BATCH, LM_SEQ, 0, smoke.num_heads,
                   smoke.num_kv_heads, smoke.resolved_head_dim, smoke.flash_block_k, "naive",
                   gen, dtype=smoke.dtype),
        flash_backward_case("train-backward", 8, LM_SEQ, h, hk, dh, torch.bfloat16, gen),
        flash_backward_case("train-backward-fp32", 8, LM_SEQ, h, hk, dh, torch.float32, gen),
        decode_case("small-tweak-decode", 8, h, hk, dh, prefix_len + 128 + 33,
                    prefix_len + 128 + 16, cfg.num_layers, gen),
        decode_case("big-miss-decode", 8, h, hk, dh, 64 + 33, 64 + 16, cfg.num_layers, gen),
        cosine_case("serve-bank", 8, LLAMA_CAPACITY, 384, 4, 1024, gen),
        cosine_case("serve-bank-1m", 8, 1 << 20, 384, 4, 1024, gen),
        cosine_case("shard-bank", 8, LLAMA_CAPACITY // CACHE_SHARDS, 384, 4, 1024, gen),
        gather_case("ivf-probe", 8, LLAMA_CAPACITY, 8, 256, 384, 4, 8, gen),
        gather_case("ivf-probe-1m", 8, 1 << 20, 8, 1024, 384, 4, 8, gen),
        block_case("small-tweak-verify-k4", 8, 4, h, hk, dh, tweak_cap, tweak_len,
                   cfg.num_layers, gen),
        block_case("small-tweak-verify-k1", 8, 1, h, hk, dh, tweak_cap, tweak_len,
                   cfg.num_layers, gen),
        paged_case("small-tweak-paged-decode", 8, 1, h, hk, dh, PAGE, tweak_cap, tweak_len + 1,
                   prefix_len, cfg.num_layers, gen, block=False),
        paged_case("small-tweak-paged-verify-k4", 8, 4, h, hk, dh, PAGE, tweak_cap, tweak_len,
                   prefix_len, cfg.num_layers, gen, block=True),
        paged_case("small-tweak-paged-verify-k1", 8, 1, h, hk, dh, PAGE, tweak_cap, tweak_len,
                   prefix_len, cfg.num_layers, gen, block=True),
    ] + arch_kernel_cases(prefix_len, gen)


def arch_kernel_cases(prefix_len: int, gen):
    """The kernel instances the dense variants, the MoE stacks and the
    recurrent hybrid add, each at the shape the ``archs`` phase (or a CLI
    run) drives: every arch's prefill (B 4, 128 tokens, causal from 0) and
    decode (a 161-slot cache mid-decode) at its head dim and G (arctic's
    are deepseek's; mamba2 has no attention), each windowed stack's prefill
    64 tokens past its window (danube 4,160, recurrentgemma 2,112) and its
    full ring (4,096 and 2,048 slots; recurrentgemma at dh 256, G 16),
    nemotron's verify block and paged kernels (dh 192, G 12), qwen3-moe's
    (G 16), the train CLI's default smoke flash (qwen2.5-3b smoke: fp32, dh
    32, recurrentgemma smoke's shape too; the MoE smoke configs' is llama
    smoke's, ``train-cli-smoke-fp32``) and the serve CLI's tiny stack's
    fp32 dh-16 decode (its big model's MISS decode and its small model's
    TWEAK decode)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import model_configs
    from repro_torch.models.transformer import attention_layers
    cases = []
    cap, mid = ARCH_PROMPT + ARCH_NEW + 1, ARCH_PROMPT + ARCH_NEW // 2 + 1
    for arch, _ in ARCHS:
        cfg = get_config(arch)
        n = attention_layers(cfg)
        if arch in ARCH_KERNEL_CASES_OF or not n:  # cases named below; no attention
            continue
        h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        cases.append(flash_case(f"{arch}-prefill", ARCH_BATCH, ARCH_PROMPT, 0, h, hk, dh,
                                cfg.flash_block_k, "naive", gen))
        cases.append(decode_case(f"{arch}-decode", ARCH_BATCH, h, hk, dh, cap, mid, n, gen))
    for arch, _ in ARCHS:
        cfg = get_config(arch)
        if not cfg.sliding_window:
            continue
        rows, past, _ = RING
        h, hk, dh, w = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                        cfg.sliding_window)
        cases.append(flash_case(f"{arch}-long-prefill", rows, w + past, 0, h, hk, dh,
                                cfg.flash_block_k, "xla_flash", gen, window=w))
        cases.append(decode_case(f"{arch}-ring-decode", rows, h, hk, dh, w, w,
                                 attention_layers(cfg), gen))
    nem = get_config("nemotron-4-340b")
    h, hk, dh, n = nem.num_heads, nem.num_kv_heads, nem.resolved_head_dim, nem.num_layers
    cases += [
        block_case("nemotron-4-340b-verify-k4", ARCH_BATCH, SPEC_K, h, hk, dh, cap, mid, n,
                   gen),
        paged_case("nemotron-4-340b-paged-decode", ARCH_BATCH, 1, h, hk, dh, PAGE, cap,
                   mid + 1, 0, n, gen, block=False),
        paged_case("nemotron-4-340b-paged-verify-k4", ARCH_BATCH, SPEC_K, h, hk, dh, PAGE,
                   cap, mid, 0, n, gen, block=True),
    ]
    # qwen3-moe at G 16 on the paths ``paths_check`` drives: the Generator's
    # verify blocks (B 4), the sessions' paged decode and verify (8 slots)
    moe = get_config(MOE_PATHS_ARCH)
    h, hk, dh, n = moe.num_heads, moe.num_kv_heads, moe.resolved_head_dim, moe.num_layers
    cases += [
        block_case(f"{MOE_PATHS_ARCH}-verify-k4", ARCH_BATCH, SPEC_K, h, hk, dh, cap, mid, n,
                   gen),
        paged_case(f"{MOE_PATHS_ARCH}-paged-decode", 8, 1, h, hk, dh, PAGE, cap, mid + 1, 0,
                   n, gen, block=False),
        paged_case(f"{MOE_PATHS_ARCH}-paged-verify-k4", 8, SPEC_K, h, hk, dh, PAGE, cap, mid,
                   0, n, gen, block=True),
    ]
    cases += frontend_kernel_cases(gen)
    cases += small_head_dim_cases(prefix_len, gen)
    smoke = get_config(TRAIN_CLI_ARCH, smoke=True)
    cases.append(flash_case("train-cli-default-smoke-fp32", LM_BATCH, LM_SEQ, 0,
                            smoke.num_heads, smoke.num_kv_heads, smoke.resolved_head_dim,
                            smoke.flash_block_k, "naive", gen, dtype=smoke.dtype))
    # the train CLI's --arch recurrentgemma-9b: its smoke config's windowed
    # fp32 flash at dh 32, G 4 (mamba2's smoke config has no attention)
    smoke = get_config("recurrentgemma-9b", smoke=True)
    cases.append(flash_case("train-cli-recurrentgemma-smoke-fp32", LM_BATCH, LM_SEQ, 0,
                            smoke.num_heads, smoke.num_kv_heads, smoke.resolved_head_dim,
                            smoke.flash_block_k, "naive", gen, dtype=smoke.dtype,
                            window=smoke.sliding_window))
    # the serve CLI's most frequent decode calls: the big model's MISS batches
    # of 4 over a 64-token bucket, the small model's TWEAK batches of 8 over the
    # prefix and a 64-token suffix bucket, 8 new tokens
    big, small, _, _ = model_configs("serve-tiny")
    cases.append(decode_case("serve-cli-big-miss-decode-fp32", 4, big.num_heads,
                             big.num_kv_heads, big.resolved_head_dim, 64 + 8 + 1, 64 + 4,
                             big.num_layers, gen, dtype=big.dtype))
    cases.append(decode_case("serve-cli-small-tweak-decode-fp32", 8, small.num_heads,
                             small.num_kv_heads, small.resolved_head_dim,
                             prefix_len + 64 + 8 + 1, prefix_len + 64 + 4, small.num_layers,
                             gen, dtype=small.dtype))
    return cases


def small_head_dim_cases(prefix_len: int, gen):
    """The fp32 instances below dh 32 of the dense decode, verify and paged
    kernels (a warp takes 2 or 4 cache slots at once), at the shapes the
    ``smoke_paths`` and ``examples`` phases drive.  Dense decode at dh 24:
    nemotron-4-340b's smoke config (G 4; ``SMOKE_BATCH`` rows over
    ``SMOKE_PROMPT + SMOKE_NEW + 1`` slots, mid-decode) and the small LM of
    ``examples/serve_e2e.py`` (G 2; TWEAK batches of 8 over the prefix, a
    64-token suffix bucket and 12 new tokens).  The verify block (K 4 and
    K 1), paged decode and paged verify (K 4) at dh 16 G 2 (the serve
    CLI's tiny stack's small model, its TWEAK shape: the prefix's pages
    pinned, a TRASH row), dh 16 G 4 (the dh-16 smoke configs), dh 24 G 4
    (nemotron-4-340b smoke) and dh 32 G 2 (qwen2.5-3b smoke), at the smoke
    paths' shape."""
    from repro_torch.configs import get_config
    from repro_torch.examples.serve_e2e import lm_configs
    from repro_torch.launch.serve import model_configs
    f32 = "float32"
    cap, mid = SMOKE_PROMPT + SMOKE_NEW + 1, SMOKE_PROMPT + SMOKE_NEW // 2
    nem = get_config("nemotron-4-340b", smoke=True)
    e2e = lm_configs()[1]
    cases = [
        decode_case("nemotron-4-340b-smoke-decode-fp32", SMOKE_BATCH, nem.num_heads,
                    nem.num_kv_heads, nem.resolved_head_dim, cap, mid + 1, nem.num_layers, gen,
                    dtype=f32),
        decode_case("serve-e2e-small-tweak-decode-fp32", 8, e2e.num_heads, e2e.num_kv_heads,
                    e2e.resolved_head_dim, prefix_len + 64 + 12 + 1, prefix_len + 64 + 6,
                    e2e.num_layers, gen, dtype=f32),
    ]
    tiny = model_configs("serve-tiny")[1]
    shapes = [("serve-tiny-small", tiny, 8, prefix_len + 64 + 8 + 1, prefix_len + 64 + 2,
               prefix_len)]
    shapes += [(f"{arch}-smoke", get_config(arch, smoke=True), SMOKE_BATCH, cap, mid, 0)
               for arch in ("deepseek-coder-33b", "nemotron-4-340b", "qwen2.5-3b")]
    for label, cfg, b, t, length, pin in shapes:
        h, hk, dh, n = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
        tag = f"{label}-dh{dh}-g{h // hk}-fp32"
        cases += [
            block_case(f"{tag}-verify-k4", b, SPEC_K, h, hk, dh, t, length, n, gen, dtype=f32),
            block_case(f"{tag}-verify-k1", b, 1, h, hk, dh, t, length, n, gen, dtype=f32),
            paged_case(f"{tag}-paged-decode", b, 1, h, hk, dh, PAGE, t, length + 1, pin, n,
                       gen, block=False, dtype=f32),
            paged_case(f"{tag}-paged-verify-k4", b, SPEC_K, h, hk, dh, PAGE, t, length, pin,
                       n, gen, block=True, dtype=f32),
        ]
    return cases


def frontend_kernel_cases(gen):
    """The instances whisper-tiny and internvl2-26b add, at the shapes the
    ``archs`` phase and their train CLI runs drive.  whisper (B 4, H 6 / 6,
    dh 64, G 1): the encoder over its 1,500 frames and the cross prefill of
    128 queries over them (non-causal, bf16), the decoder's causal prefill,
    the self decode (161 slots) and the cross decode over every one of the
    1,500 frames, a layer's caches apart for each of the 4 layers; its train
    CLI's smoke cross attention (fp32 dh 32, 128 queries over 16 frames).
    internvl2 (H 48 / 8, G 6, dh 128) behind its 256 prefix positions: the
    prefill of 384 positions, the dense decode, the K-4 verify block and the
    paged decode and verify over 417 slots (the Generator's capacity with
    the prefix), its train CLI's smoke flash (fp32 dh 16, G 4, 136
    positions)."""
    from repro_torch.configs import get_config
    cap, mid = ARCH_PROMPT + ARCH_NEW + 1, ARCH_PROMPT + ARCH_NEW // 2 + 1
    wh, ws = get_config("whisper-tiny"), get_config("whisper-tiny", smoke=True)
    h, hk, dh, f, n = (wh.num_heads, wh.num_kv_heads, wh.resolved_head_dim, wh.enc_frames,
                       wh.num_layers)
    block = wh.flash_block_k
    cases = [
        flash_case("whisper-encoder", ARCH_BATCH, f, 0, h, hk, dh, block, "naive", gen,
                   causal=False),
        flash_case("whisper-cross-prefill", ARCH_BATCH, ARCH_PROMPT, 0, h, hk, dh, block,
                   "naive", gen, causal=False, sk=f),
        flash_case("whisper-decoder-prefill", ARCH_BATCH, ARCH_PROMPT, 0, h, hk, dh, block,
                   "naive", gen),
        decode_case("whisper-self", ARCH_BATCH, h, hk, dh, cap, mid, n, gen),
        decode_case("whisper-cross", ARCH_BATCH, h, hk, dh, f, f, n, gen),
        flash_case("train-cli-whisper-fp32", LM_BATCH, LM_SEQ, 0, ws.num_heads,
                   ws.num_kv_heads, ws.resolved_head_dim, ws.flash_block_k, "naive", gen,
                   dtype=ws.dtype, causal=False, sk=ws.enc_frames),
    ]
    iv, ism = get_config("internvl2-26b"), get_config("internvl2-26b", smoke=True)
    h, hk, dh, n, p = (iv.num_heads, iv.num_kv_heads, iv.resolved_head_dim, iv.num_layers,
                       iv.num_prefix_tokens)
    return cases + [
        flash_case("internvl2-prefill", ARCH_BATCH, p + ARCH_PROMPT, 0, h, hk, dh,
                   iv.flash_block_k, "naive", gen),
        decode_case("internvl2", ARCH_BATCH, h, hk, dh, p + cap, p + mid, n, gen),
        block_case("internvl2-K4", ARCH_BATCH, SPEC_K, h, hk, dh, p + cap, p + mid, n, gen),
        paged_case("internvl2", ARCH_BATCH, 1, h, hk, dh, PAGE, p + cap, p + mid + 1, 0, n,
                   gen, block=False),
        paged_case("internvl2-K4", ARCH_BATCH, SPEC_K, h, hk, dh, PAGE, p + cap, p + mid, 0,
                   n, gen, block=True),
        flash_case("train-cli-internvl2-fp32", LM_BATCH, ism.num_prefix_tokens + LM_SEQ, 0,
                   ism.num_heads, ism.num_kv_heads, ism.resolved_head_dim,
                   ism.flash_block_k, "naive", gen, dtype=ism.dtype),
    ]


# ------------------------------------------------------------------ train

TRAIN_LR = 1e-3                # both trainers' learning rate (their default)


def _timed_batches(make, steps: int, step_ms: list):
    """``steps`` batches from ``make()``; appends each step's wall ms (from
    the batch's hand-over to the next request, which the trainer makes after
    reading the step's loss back) to ``step_ms``."""
    for _ in range(steps):
        batch = make()
        t = time.perf_counter()
        yield batch
        step_ms.append((time.perf_counter() - t) * 1e3)


def _parity_step(params, opt, loss_fn, cfg, batch):
    """One more AdamW step from copies of ``params`` and ``opt``, on the
    device and on the CPU, on the same batch: (max |delta param|, share of
    elements apart by more than 1e-5, the two losses).  An element whose
    gradient is rounding noise may step the other way: AdamW moves it by up
    to 2 * lr."""
    from repro_torch.training.optimizer import (AdamWConfig, train_loop, tree_leaves,
                                                tree_map)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
    runs = []
    for to in (lambda t: t.detach().clone(), lambda t: t.detach().cpu().clone()):
        p, o = tree_map(to, params), {"m": tree_map(to, opt["m"]), "v": tree_map(to, opt["v"]),
                                      "step": opt["step"]}
        loss = train_loop(p, o, opt_cfg, loss_fn, cfg, [tuple(to(t) for t in batch)])[0]
        runs.append((p, loss))
    (p_dev, loss_dev), (p_cpu, loss_cpu) = runs
    worst, apart, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)):
        d = (a.float().cpu() - b.float()).abs()
        worst = max(worst, float(d.max()))
        apart += int((d > 1e-5).sum())
        n += d.numel()
    return {"max_abs_param_diff": worst, "share_apart_1e-5": apart / n,
            "loss_device": loss_dev, "loss_cpu": loss_cpu,
            "loss_rel_diff": abs(loss_dev - loss_cpu) / max(abs(loss_cpu), 1e-12)}


def _check_training(name, losses, parity):
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if not last < first:
        raise AssertionError(f"{name}: the last 10-step mean loss {last} is not below the "
                             f"first {first}")
    if not (parity["loss_rel_diff"] <= 1e-4 and parity["share_apart_1e-5"] < 1e-3
            and parity["max_abs_param_diff"] <= 2 * TRAIN_LR):
        raise AssertionError(f"{name}: the card's step is not the CPU's: {parity}")
    return {"first10_loss": first, "last10_loss": last}


def train_phase(model: str, device, seed: int, emb_steps: int = 60, emb_batch: int = 16,
                rr_steps: int = 120, rr_batch: int = 32, held_out: int = 256):
    """Train the stack's embedder and reranker on the device as ``build_stack``
    does (same initial weights, same batches: ``QuestionPairGenerator(0)``),
    timing each step; one parity step against the CPU; held-out quality on
    ``held_out`` triples / pairs of another seed, before and after.
    Returns (train line, (reranker params, reranker config))."""
    import numpy as np
    import torch
    from repro_torch.data import QuestionPairGenerator
    from repro_torch.launch.serve import build_embedder, model_configs
    from repro_torch.models.embedder import encode
    from repro_torch.models.reranker import init_reranker, score_pairs
    from repro_torch.tokenizer import HashWordTokenizer
    from repro_torch.training import embedder_train, reranker_train
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, train_loop
    big, _, ecfg, rr_cfg = model_configs(model)
    tok = HashWordTokenizer(big.vocab_size)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
    held = QuestionPairGenerator(seed=seed + 1000)
    triples = embedder_train.triple_batch(held, tok, held_out, 32, device)
    pairs = reranker_train.pair_batch(held, tok, held_out, 24, 0.5, device)

    def separation(params):
        with torch.no_grad():
            za, zb, zn = (encode(params, triples[2 * j], triples[2 * j + 1], ecfg)
                          for j in range(3))
        return float(((za * zb).sum(-1).mean() - (za * zn).sum(-1).mean()).item())

    def accuracy(params):
        with torch.no_grad():
            logits = score_pairs(params, *pairs[:4], rr_cfg)
        return float(((logits > 0).float() == pairs[4]).float().mean().item())

    def run(name, params, loss_fn, cfg, make, steps, quality):
        before = quality(params)
        opt, step_ms = init_opt_state(params), []
        _sync(device)
        t0 = time.perf_counter()
        losses = train_loop(params, opt, opt_cfg, loss_fn, cfg,
                            _timed_batches(make, steps, step_ms))
        _sync(device)
        seconds = time.perf_counter() - t0
        parity = _parity_step(params, opt, loss_fn, cfg, make())
        return {"steps": steps, "seconds": seconds,
                "median_step_ms": float(np.median(step_ms)),
                **_check_training(name, losses, parity), "parity": parity,
                "quality_before": before, "quality_after": quality(params)}

    gen = QuestionPairGenerator(seed=0)
    eparams, _ = build_embedder(model, device=device, seed=seed)
    emb = run("embedder", eparams, embedder_train.info_nce_loss, ecfg,
              lambda: embedder_train.triple_batch(gen, tok, emb_batch, 32, device),
              emb_steps, separation)
    emb.update(batch=emb_batch, quality="mean cos(duplicate) - mean cos(hard negative), "
               f"{held_out} held-out triples")
    gen = QuestionPairGenerator(seed=0)
    rr = init_reranker(rr_cfg, torch.Generator(device=device).manual_seed(seed + 3), device)
    rer = run("reranker", rr, reranker_train.pair_bce_loss, rr_cfg,
              lambda: reranker_train.pair_batch(gen, tok, rr_batch, 24, 0.5, device),
              rr_steps, accuracy)
    rer.update(batch=rr_batch, quality=f"accuracy of logit > 0 on {held_out} held-out pairs "
               "(half duplicates, half hard negatives)")
    row = {"phase": "train", "embedder": dict(emb, config=ecfg.name, layers=ecfg.num_layers,
                                              d_model=ecfg.d_model, vocab=ecfg.vocab_size),
           "reranker": dict(rer, config=rr_cfg.name, layers=rr_cfg.num_layers,
                            d_model=rr_cfg.d_model, vocab=rr_cfg.vocab_size),
           "lr": TRAIN_LR}
    return row, (rr, rr_cfg)


# ------------------------------------------------------------------ LM training and the judge

LM_LAYERS = 4       # llama-3.1-8b at full width, depth cut: 32 layers of bf16 params and
                    # grads with fp32 moments (~96 GB) exceed the card's 80 GB; 4 take ~23 GB
LM_STEPS = 40
LM_BATCH, LM_SEQ = 8, 128
LM_LR = 1e-3        # the train CLI's default
JUDGE_PAIRS = 48
JUDGE_MAX_LEN = 128
JUDGE_CPU_ROWS = 2
# a card score (bf16 weights and activations) against the same weights cast to
# fp32 on the CPU, absolute, on a mean log-probability of about -1 nat: about
# ten times the gap of 0.0009 read on an H100 80GB HBM3 (700 W), so that one
# layer's attention off by a little shows
JUDGE_CPU_TOL = 0.01
# the microbatch check: bf16 gradients of bf16 activations (2^-9 relative
# rounding an element, and the halves' matmuls are cut differently from the
# whole batch's), against a half batch, an undivided sum or a flipped sign,
# each off by a sizeable share of the largest |g|
MICRO_GRAD_REL = 2e-2
MICRO_LOSS_REL = 1e-3


def _to_device(batch, device):
    import torch
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def judge_sets(seed: int, n: int):
    """``n`` duplicate pairs of ``QuestionPairGenerator(seed)``: the second
    query of each, its big and small synthesized responses, and the big ones
    with their words shuffled by a seeded RNG."""
    import numpy as np
    from repro_torch.data import QuestionPairGenerator, synthesize_response
    gen, rng = QuestionPairGenerator(seed=seed), np.random.default_rng(seed + 7)
    sets = {"queries": [], "big": [], "small": [], "shuffled": []}
    for _ in range(n):
        _, q = gen.duplicate_pair()
        big = synthesize_response(q.text, q.topic, q.intent, quality="big")
        sets["queries"].append(q.text)
        sets["big"].append(big)
        sets["small"].append(synthesize_response(q.text, q.topic, q.intent, quality="small"))
        sets["shuffled"].append(" ".join(rng.permutation(big.split())))
    return sets


def score_sets(model, params, tok, sets, device):
    """Mean-loglik scores of each response set (``make_loglik_scorer``,
    max_len 128), ms per set and the flash launches of the three."""
    import numpy as np
    from repro_torch.eval import make_loglik_scorer
    from repro_torch.kernels.flash_attention import ops as flash_ops
    score = make_loglik_scorer(model, params, tok, max_len=JUDGE_MAX_LEN)
    scores, ms, before = {}, {}, flash_ops.launches
    for name in ("big", "small", "shuffled"):
        _sync(device)
        t = time.perf_counter()
        scores[name] = score(sets["queries"], sets[name])
        ms[name] = (time.perf_counter() - t) * 1e3
        if scores[name].shape != (len(sets["queries"]),) or not np.isfinite(scores[name]).all():
            raise AssertionError(f"judge: {name} scores not finite of shape (n,)")
    return scores, ms, flash_ops.launches - before


def _microbatch_check(model, params, batch, full_grads, full_loss):
    """The gradients a ``microbatches=2`` step applies (``trainer.
    microbatch_value_and_grad``: fp32 sums over the two halves, divided by 2)
    against the whole batch's (``value_and_grad``, what ``microbatches=1``
    applies), which they equal on a batch whose halves hold as many tokens:
    each leaf within ``MICRO_GRAD_REL`` of the whole batch's largest |g|,
    the losses within ``MICRO_LOSS_REL``."""
    import torch
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import microbatch_value_and_grad
    torch.cuda.reset_peak_memory_stats()
    loss, grads = microbatch_value_and_grad(model, params, batch, 2)
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(grads)
    if any(g.dtype != torch.float32 for g in leaves):
        raise AssertionError("lm_train: microbatch gradients not accumulated in fp32")
    worst = 0.0
    for got, want in zip(leaves, tree_leaves(full_grads)):
        scale = float(want.abs().max())
        err = float((got - want.float()).abs().max())
        worst = max(worst, err / scale)
        if not err <= MICRO_GRAD_REL * scale:
            raise AssertionError(f"lm_train: a microbatches-2 gradient leaf is {err} from the "
                                 f"whole batch's, past {MICRO_GRAD_REL} of its largest |g| "
                                 f"{scale}")
    loss, full_loss = float(loss), float(full_loss)
    if not abs(loss - full_loss) <= MICRO_LOSS_REL * abs(full_loss):
        raise AssertionError(f"lm_train: microbatches-2 loss {loss} against {full_loss}")
    return {"max_grad_err_over_leaf_max": worst, "grad_tolerance": MICRO_GRAD_REL,
            "loss_mb1": full_loss, "loss_mb2": loss, "loss_tolerance": MICRO_LOSS_REL,
            "max_memory_allocated_gb": peak / 1e9}


def lm_train_phase(device, seed: int, sets):
    """llama-3.1-8b at full width, depth cut to ``LM_LAYERS``, trained on the
    card through ``make_train_step`` on ``token_stream_batches``: a gradient
    check of step 1's batch (every leaf, every layer's attention weights), a
    microbatch check, ``LM_STEPS`` timed steps, and the train CLI on its
    smoke config.  The judge scores before training are taken here too.
    Returns (line, model, trained params, tokenizer, scores before)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.configs import llama31_8b
    from repro_torch.data import token_stream_batches
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.tokenizer import HashWordTokenizer
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import value_and_grad
    t0 = time.perf_counter()
    cfg = llama31_8b.CONFIG.replace(num_layers=LM_LAYERS)
    model = build_model(cfg)
    tok = HashWordTokenizer(cfg.vocab_size)
    params = model.init(torch.Generator(device=device).manual_seed(seed + 20), device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    before = score_sets(model, params, tok, sets, device)
    stream = token_stream_batches(tok, LM_BATCH, LM_SEQ, seed=seed)
    first = _to_device(next(stream), device)
    opt_cfg = AdamWConfig(lr=LM_LR)

    # step 1's gradients: value_and_grad raises if a leaf gets none
    n0 = flash_ops.launches
    loss0, _, grads = value_and_grad(model, params, first)
    grad_launches = flash_ops.launches - n0
    attn = [(float(g["attn"]["w_qkv"].abs().max()), float(g["attn"]["w_o"].abs().max()))
            for g in grads["layers"]]
    g_leaves = tree_leaves(grads)
    if len(g_leaves) != len(tree_leaves(params)) or not all(a > 0 and b > 0 for a, b in attn):
        raise AssertionError(f"lm_train: a layer's attention weights got no gradient: {attn}")
    grad_check = {"leaves": len(g_leaves), "leaves_with_grad": len(g_leaves),
                  "leaves_nonzero": sum(bool(g.abs().max() > 0) for g in g_leaves),
                  "w_qkv_abs_max": [a for a, _ in attn], "w_o_abs_max": [b for _, b in attn],
                  "flash_launches": grad_launches}
    del g_leaves
    micro = _microbatch_check(model, params, first, grads, loss0)
    del grads

    step = make_train_step(model, opt_cfg, total_steps=LM_STEPS)
    opt = init_opt_state(params)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    n0 = flash_ops.launches
    batch = first
    for i in range(LM_STEPS):
        if i:
            batch = _to_device(next(stream), device)
        _sync(device)
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))                # reads the loss: synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = flash_ops.launches - n0
    peak = torch.cuda.max_memory_allocated()
    del opt
    torch.cuda.empty_cache()
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (np.isfinite(losses).all() and last10 < first10):
        raise AssertionError(f"lm_train: the last 10-step mean loss {last10} is not below "
                             f"the first {first10}")
    if launches != LM_STEPS * 2 * LM_LAYERS:
        raise AssertionError(f"lm_train: {launches} flash launches in {LM_STEPS} steps, not "
                             f"2 a layer a step (forward and the remat recompute)")
    out = io.StringIO()
    n0 = flash_ops.launches
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--steps", "20", "--log-every", "10"])
    cli_launches = flash_ops.launches - n0
    cli_lines = out.getvalue().strip().splitlines()
    if rc != 0 or not cli_lines[0].startswith(f"arch={TRAIN_CLI_ARCH} "):
        raise AssertionError(f"lm_train: the train CLI returned {rc}: {cli_lines}")
    if cli_launches != 20 * 2:
        raise AssertionError(f"lm_train: the train CLI launched flash {cli_launches} times, "
                             f"not once a layer a step (2 layers, 20 steps)")
    med = float(np.median(step_ms))
    line = {"phase": "lm_train", "seconds": time.perf_counter() - t0, "config": cfg.name,
            "layers": LM_LAYERS,
            "depth_cut_from": llama31_8b.CONFIG.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
            "params": n_params, "batch": LM_BATCH, "seq": LM_SEQ, "lr": LM_LR,
            "steps": LM_STEPS, "median_step_ms": med, "first_step_ms": step_ms[0],
            "tokens_per_s": LM_BATCH * LM_SEQ / (med / 1e3),
            "max_memory_allocated_gb": peak / 1e9,
            "flash_launches": launches, "flash_launches_per_step": launches / LM_STEPS,
            "first10_loss": first10, "last10_loss": last10, "loss_first": losses[0],
            "loss_last": losses[-1], "grad_check": grad_check, "microbatch_check": micro,
            "cli": {"rc": rc, "args": "--steps 20 --log-every 10 (the default --arch "
                                      f"{TRAIN_CLI_ARCH}, its smoke config)",
                    "flash_launches": cli_launches,
                    "first_line": cli_lines[0], "last_line": cli_lines[-1]}}
    return line, model, params, tok, before


def judge_phase(model, params, tok, sets, before, device, seed: int):
    """The trained referee scores the big, small and shuffled response sets
    (real must score above shuffled), two pairs again on the CPU in fp32
    against the card, and the debate of big against small."""
    import numpy as np
    from repro_torch.eval import PERSONAS, debate_batch, make_loglik_scorer, verdict_shares
    from repro_torch.training.optimizer import tree_map
    t0 = time.perf_counter()
    after, ms, launches = score_sets(model, params, tok, sets, device)
    means = lambda sc: {k: float(np.mean(v)) for k, v in sc.items()}
    m_before, m_after = means(before[0]), means(after)
    if not m_after["big"] > m_after["shuffled"]:
        raise AssertionError(f"judge: after training real {m_after['big']} does not score "
                             f"above shuffled {m_after['shuffled']}")
    rows = slice(0, JUDGE_CPU_ROWS)
    cpu_params = tree_map(lambda t: t.detach().float().cpu(), params)
    cpu_score = make_loglik_scorer(model, cpu_params, tok, max_len=JUDGE_MAX_LEN)
    card = after["big"][rows]
    cpu = cpu_score(sets["queries"][rows], sets["big"][rows])
    del cpu_params
    gap = np.abs(card - cpu)
    if not (gap <= JUDGE_CPU_TOL).all():
        raise AssertionError(f"judge: card scores {card} against the CPU's {cpu} "
                             f"(tol {JUDGE_CPU_TOL})")
    results = debate_batch(sets["queries"], sets["big"], sets["small"],
                           [float(x) for x in after["big"]], [float(x) for x in after["small"]],
                           seed=seed)
    shares = verdict_shares(results)
    if abs(sum(shares.values()) - 1.0) > 1e-9:
        raise AssertionError(f"judge: verdict shares {shares} do not sum to 1")
    margins = np.array([r.margins for r in results])
    return {"phase": "judge", "seconds": time.perf_counter() - t0, "referee": f"lm_train's {model.cfg.num_layers}-layer "
                                         f"{model.cfg.name}", "pairs": len(sets["queries"]),
            "max_len": JUDGE_MAX_LEN, "mean_loglik_before": m_before,
            "mean_loglik_after": m_after, "ms_per_set": ms, "ms_per_set_before": before[1],
            "flash_launches": launches, "flash_launches_before": before[2],
            "card_vs_cpu": {"rows": JUDGE_CPU_ROWS, "card": card.tolist(), "cpu": cpu.tolist(),
                            "max_abs_diff": float(gap.max()), "tolerance": JUDGE_CPU_TOL},
            "debate_big_vs_small": {"shares": shares,
                                    "mean_margin_by_persona": {
                                        p.name: float(margins[:, i].mean())
                                        for i, p in enumerate(PERSONAS)}}}


# ------------------------------------------------------------------ the zero trainer

ZERO_LAYERS = 2     # llama-3.1-8b at full width, depth cut: 2 layers keep the phase's time
#                     and memory down (params 3.0 GB bf16, moments 11.9 GB, the fp32
#                     bucket 6.0 GB)
ZERO_MICRO, ZERO_STEPS = 4, 3


def zero_train_phase(device, seed: int):
    """``launch.zero_trainer.make_zero_train_step`` on a one-rank process
    group (NCCL on the card, gloo on the CPU; an in-memory store, no port):
    llama-3.1-8b at full width, ``ZERO_LAYERS`` layers, batch ``LM_BATCH`` x
    ``LM_SEQ`` as ``ZERO_MICRO`` microbatches, ``ZERO_STEPS`` steps, one
    all-reduce a step; then the same steps of ``make_train_step(microbatches=
    ZERO_MICRO)`` from the same start (kept on the host meanwhile): losses and
    every parameter bit for bit (a one-rank sum is the identity and the
    division is by 1)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import llama31_8b
    from repro_torch.data import token_stream_batches
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import zero_trainer
    from repro_torch.launch.collectives import collective_bytes
    from repro_torch.launch.mesh import NamedMesh
    from repro_torch.models import build_model
    from repro_torch.tokenizer import HashWordTokenizer
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    t0 = time.perf_counter()
    cfg = llama31_8b.CONFIG.replace(num_layers=ZERO_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed + 30), device)
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    start = [p.to("cpu", copy=True) for p in leaves]
    stream = token_stream_batches(HashWordTokenizer(cfg.vocab_size), LM_BATCH, LM_SEQ,
                                  seed=seed + 30)
    batches = [_to_device(next(stream), device) for _ in range(ZERO_STEPS)]
    opt_cfg = AdamWConfig(lr=LM_LR)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    calls, handed = [], []
    inner = dist.all_reduce

    def counted(*a, **k):
        calls.append(a[0].numel())
        handed.append(a[0].numel() * a[0].element_size())
        return inner(*a, **k)
    dist.all_reduce = counted
    try:
        step = zero_trainer.make_zero_train_step(model, opt_cfg, dist.group.WORLD,
                                                 microbatches=ZERO_MICRO,
                                                 total_steps=ZERO_STEPS)
        opt = init_opt_state(params)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        n0 = flash_ops.launches
        losses, step_ms = [], []
        for batch in batches:
            _sync(device)
            t = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))                # reads the loss: synchronises
            step_ms.append((time.perf_counter() - t) * 1e3)
        launches = flash_ops.launches - n0
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    finally:
        dist.all_reduce = inner
        dist.destroy_process_group()
    zero_final = [p.to("cpu", copy=True) for p in leaves]
    del opt, metrics
    with torch.no_grad():
        for p, s in zip(leaves, start):
            p.copy_(s)
    del start
    plain = make_train_step(model, opt_cfg, microbatches=ZERO_MICRO, total_steps=ZERO_STEPS)
    opt = init_opt_state(params)
    plain_losses, plain_ms = [], []
    for batch in batches:
        _sync(device)
        t = time.perf_counter()
        params, opt, metrics = plain(params, opt, batch)
        plain_losses.append(float(metrics["loss"]))
        plain_ms.append((time.perf_counter() - t) * 1e3)
    diffs = [float((a.float() - b.cpu().float()).abs().max()) for a, b in zip(zero_final, leaves)]
    bitwise = losses == plain_losses and all(torch.equal(a, b.cpu())
                                             for a, b in zip(zero_final, leaves))
    del params, opt, metrics, leaves, zero_final
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if len(calls) != ZERO_STEPS:
        raise AssertionError(f"zero_train: {len(calls)} all-reduces in {ZERO_STEPS} steps, "
                             "not one a step")
    if not bitwise:
        raise AssertionError(f"zero_train: the one-rank zero step differs from the plain "
                             f"microbatched step: losses {losses} vs {plain_losses}, largest "
                             f"parameter difference {max(diffs)}")
    if launches != ZERO_STEPS * ZERO_MICRO * 2 * ZERO_LAYERS:
        raise AssertionError(f"zero_train: {launches} flash launches, not 2 a layer a "
                             f"microbatch (forward and the remat recompute)")
    # the dry-run's reckoning of this step (launch/collectives.py) on a data
    # mesh of two ranks, each holding this batch: the bucket a rank hands the
    # all-reduce does not depend on the group's size, and a one-device group
    # reckons nothing (XLA drops a collective over one device)
    mesh = NamedMesh.of((2,), ("data",))
    reckoned, reckoned_once, trips = collective_bytes(
        cfg, "train", LM_SEQ, 2 * LM_BATCH, mesh, microbatches=ZERO_MICRO,
        grad_sync_once=True)
    if any(b != {"all-reduce": h} for h in handed for b in (reckoned, reckoned_once)):
        raise AssertionError(f"zero_train: NCCL was handed {handed} bytes a step, the "
                             f"reckoning says {reckoned} (body once {reckoned_once})")
    return {"phase": "zero_train", "seconds": time.perf_counter() - t0, "config": cfg.name,
            "layers": ZERO_LAYERS, "depth_cut_from": llama31_8b.CONFIG.num_layers,
            "params": n_params,
            "batch": LM_BATCH, "seq": LM_SEQ, "microbatches": ZERO_MICRO,
            "steps": ZERO_STEPS, "backend": backend, "world_size": 1,
            "all_reduces": len(calls), "bucket_floats": calls[0],
            "bucket_gb": calls[0] * 4 / 1e9, "all_reduce_bytes_handed": handed,
            "reckoned_collectives": reckoned, "reckoned_body_once": reckoned_once,
            "reckoned_loop_trip_count": trips, "reckoned_mesh": mesh.name + " (data)",
            "step_ms": step_ms, "plain_step_ms": plain_ms,
            "losses": losses, "plain_losses": plain_losses, "bitwise_equal": bitwise,
            "max_param_diff": max(diffs), "max_memory_allocated_gb": None if peak is None
            else peak / 1e9, "flash_launches": launches}


# ------------------------------------------------------------------ serve

# ------------------------------------------------------------------ archs

class MoeProbe:
    """While active, wraps ``models.moe.apply_moe`` (the module attribute the
    transformer calls): each call's dropped (token, choice) pairs are
    counted per batch row on the device, read only after the run; with
    ``capture`` the first call's input (layer 0's) is kept.  It routes each
    input once more to count, so no timed run goes through it."""

    def __init__(self, capture: bool = False):
        self.capture, self.first_input, self.calls = capture, None, []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._inner = moe, moe.apply_moe

        def wrapped(params, x, cfg):
            if self.capture and self.first_input is None:
                self.first_input = x.detach().clone()
            b, s = x.shape[:2]
            _, _, _, rank, cap, _ = moe.route(params, x.detach(), cfg)
            self.calls.append((s, (rank >= cap).sum(-1).reshape(-1)[:b * s].view(b, s).sum(1)))
            return self._inner(params, x, cfg)

        moe.apply_moe = wrapped
        return self

    def __exit__(self, *exc):
        self._moe.apply_moe = self._inner

    def dropped(self, tokens=None) -> list:
        """Dropped pairs per batch row, summed over the calls (layers, steps)
        of ``tokens`` tokens a row (every call when None)."""
        rows = [r for s, r in self.calls if tokens is None or s == tokens]
        return [] if not rows else [int(v) for v in sum(rows).tolist()]


def onehot_moe(p, x, cfg):
    """The reference's GShard dispatch (``src/repro/models/moe.py:38-118``)
    transcribed literally into torch, in fp32 from the layer's own weights:
    top-k by a stable descending sort (``lax.top_k``'s lowest index on
    ties), the cumsum position of each (token, choice) in its expert, the
    (G, S, E, C) one-hot dispatch and combine tensors, and the einsums; each
    expert's weights converted to fp32 in turn (arctic's take 53 GB in fp32).
    Returns (out (B,S,d) fp32, aux * coef, keep (G,S_g,k), top-k idx)."""
    import torch
    import torch.nn.functional as F
    b, s, d = x.shape
    n = b * s
    gsz = min(cfg.moe_group_size, n)
    pad = (-n) % gsz
    xf = x.reshape(n, d).float()
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
    xg = xf.view(-1, gsz, d)
    g_, e, k = xg.shape[0], cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("gsd,de->gse", xg, p["router"])
    topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    probs = torch.softmax(logits.gather(-1, topi), dim=-1)
    me = torch.mean(torch.softmax(logits, dim=-1), dim=(0, 1))
    ce = torch.mean(F.one_hot(topi[..., 0], e).float(), dim=(0, 1))
    aux = e * torch.sum(me * ce)
    c = int(cfg.capacity_factor * k * gsz / e)
    cap = max(8, ((c + 7) // 8) * 8)
    onehot = F.one_hot(topi, e)                                      # (G,S,k,E)
    flat = onehot.reshape(g_, gsz * k, e)
    pos = torch.sum((torch.cumsum(flat, dim=1) - 1) * flat, dim=-1).reshape(g_, gsz, k)
    keep = pos < cap
    wts = probs * keep
    slot = (pos[..., None] == torch.arange(cap, device=x.device)).float()  # 0 past C
    sel = onehot.float() * keep[..., None]
    disp = torch.einsum("gske,gskc->gsec", sel, slot)
    comb = torch.einsum("gske,gskc,gsk->gsec", sel, slot, wts)
    ex_in = torch.einsum("gsec,gsd->egcd", disp, xg)
    ex_out = torch.empty_like(ex_in)
    for i in range(e):
        w_gate, w_up = p["w_gate_up"][i].float().chunk(2, dim=-1)
        h = (F.silu(torch.einsum("gcd,df->gcf", ex_in[i], w_gate))
             * torch.einsum("gcd,df->gcf", ex_in[i], w_up))
        ex_out[i] = torch.einsum("gcf,fd->gcd", h, p["w_down"][i].float())
    out = torch.einsum("egcd,gsec->gsd", ex_out, comb)
    if cfg.moe_dense_residual:
        dense = p["dense"]
        gate, up = (xg @ dense["w_gate_up"].float()).chunk(2, dim=-1)
        out = out + (F.silu(gate) * up) @ dense["w_down"].float()
    return (out.reshape(-1, d)[:n].view(b, s, d), aux * cfg.router_aux_coef, keep, topi)


MOE_TOL = 2e-2      # the bf16 MoE layer against its fp32 transcription (bf16 rounding)
MOE_AUX_TOL = 1e-5  # aux: fp32 on both sides, sums in another order


def moe_layer_check(p, x, cfg, label: str):
    """Layer 0's ``apply_moe`` on the group ``x`` against ``onehot_moe`` from
    the same weights: the same top-k experts and the same kept (token,
    choice) set exactly, outputs within MOE_TOL, aux within MOE_AUX_TOL."""
    import torch
    from repro_torch.models import moe
    got, aux = moe.apply_moe(p, x, cfg)
    _, _, idx, rank, cap, _ = moe.route(p, x, cfg)
    want, want_aux, keep, topi = onehot_moe(p, x, cfg)
    name = f"archs[{cfg.name}].moe[{label}]"
    if not torch.equal(idx, topi):
        raise AssertionError(f"{name}: the routed experts differ from the transcription's")
    if not torch.equal(rank < cap, keep):
        raise AssertionError(f"{name}: the kept (token, choice) set differs from the "
                             f"transcription's")
    err = (got.float() - want).abs().max().item()
    check(name, err, MOE_TOL)
    aux_err = abs(float(aux) - float(want_aux))
    check(name + ".aux", aux_err, MOE_AUX_TOL)
    load = torch.zeros(idx.shape[0], cfg.num_experts, device=x.device).scatter_add_(
        1, idx.reshape(idx.shape[0], -1), torch.ones(idx.shape[0], idx[0].numel(),
                                                     device=x.device))
    return {"tokens": x.shape[0] * x.shape[1], "groups": idx.shape[0],
            "group_tokens": idx.shape[1], "capacity": cap, "capacity_factor":
            cfg.capacity_factor, "pairs": keep.numel(), "dropped_pairs": int((~keep).sum()),
            "max_expert_load": int(load.max()), "mean_expert_load": float(load.mean()),
            "max_abs_out": want.abs().max().item(), "max_abs_err": err, "tolerance": MOE_TOL, "aux": float(aux),
            "aux_abs_err": aux_err, "same_experts": True, "same_kept_set": True}


def attention_calls(cfg):
    """(flash launches a prefill, decode launches a step) of a stack: one
    each an attention layer; an encoder-decoder's encoder layers launch
    flash once, its decoder layers flash and decode twice (self, cross)."""
    from repro_torch.models import encdec
    from repro_torch.models.transformer import attention_layers
    if cfg.enc_layers:
        return encdec.attention_calls(cfg)
    n = attention_layers(cfg)
    return n, n


def generate_check(model, params, rng, b: int, s: int, mnt: int, extra=None):
    """Greedy generation of ``mnt`` tokens from ``b`` random prompts of ``s``
    tokens (after the prefix embeddings, or over the frames, in ``extra``)
    through ``Generator``'s fused decode, held against one
    teacher-forced forward of ``[prompt | generated]`` (the prefill's
    attention and, in a recurrent layer, the chunked scan over the whole
    sequence where decode carried the state step by step; every position's
    logits) under the margin rule, whose
    tolerance is twice the largest logit difference between that forward and
    the decode steps fed the same tokens, plus 1e-3.  The decode steps are
    run again one by one from a prefill (timed: ms a step) and must give the
    fused loop's tokens exactly.

    A MoE stack routes each call's tokens as a group, and the forward's
    group (all rows, prompt and generated) is not the prefill's nor a decode
    step's: where either drops a pair of a row (a probed re-run counts
    them), that row's forward is another function, so the noise and the
    rule are taken over the rows where neither dropped any.  Layer 0's MoE
    is then held to its one-hot transcription (``moe_layer_check``) on the
    prefill's own group and on the first decode step's.

    Returns the run's line, the caches the step loop left and the greedy
    reference (prompts, tokens, the top-2 margin of each token's logits)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.generate import GenerateConfig, Generator
    from repro_torch.serving.sampler import SamplerConfig
    cfg, dev = model.cfg, params["embed"].device
    vocab = cfg.vocab_size
    extra = extra or {}
    off = extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra else 0
    is_moe = "moe" in params.get("layers", [{}])[0]
    toks = torch.as_tensor(rng.integers(5, vocab, (b, s)), device=dev).long()
    gen = Generator(model, params, GenerateConfig(max_new_tokens=mnt,
                                                  sampler=SamplerConfig(vocab_size=vocab)))
    with torch.no_grad():
        gen.generate_with_lengths({"tokens": toks[:, :16], **extra}, max_new_tokens=2)  # warm-up
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        tokens, lengths, _ = gen.generate_with_lengths({"tokens": toks, **extra})
        generate_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        fed = torch.as_tensor(tokens, device=dev).long()
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, {"tokens": toks, **extra}, off + s + mnt + 1)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        dec = [logits[:, :vocab].float()]
        t0 = time.perf_counter()
        for j in range(1, mnt):
            logits, caches = model.decode_step(params, fed[:, j - 1], caches)
            dec.append(logits[:, :vocab].float())
        _sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / (mnt - 1)
        dec = torch.stack(dec, 1)                                        # (B, mnt, V)
        with MoeProbe() as fwd_probe:
            full, _ = model.forward(params, {"tokens": torch.cat([toks, fed[:, :-1]], 1),
                                             **extra})
        teach = full[:, off + s - 1:, :vocab].float()
        del full
        if is_moe:
            with MoeProbe(capture=True) as pre_probe:
                _, probe_caches = model.prefill(params, {"tokens": toks}, s + mnt + 1)
            with MoeProbe(capture=True) as step_probe:
                model.decode_step(params, fed[:, 0], probe_caches)
            del probe_caches
    live = torch.arange(mnt, device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None]
    if not torch.equal(torch.where(live, dec.argmax(-1), fed), fed):
        raise AssertionError(f"archs[{cfg.name}]: the fused decode's tokens differ from "
                             f"the same steps run one by one")
    clean = torch.ones(b, dtype=torch.bool, device=dev)
    moe_line = None
    if is_moe:
        dropped = {"prefill": pre_probe.dropped(), "forward": fwd_probe.dropped(),
                   "decode_step": step_probe.dropped()}
        if any(dropped["decode_step"]):
            raise AssertionError(f"archs[{cfg.name}]: a decode step of {b} tokens dropped "
                                 f"pairs: {dropped['decode_step']}")
        clean = torch.as_tensor([p == 0 and f == 0 for p, f in
                                 zip(dropped["prefill"], dropped["forward"])], device=dev)
        layer0 = params["layers"][0]["moe"]
        moe_line = {"dropped_pairs_by_row": dropped,
                    "rows_without_drops": int(clean.sum()),
                    "prefill_group": moe_layer_check(layer0, pre_probe.first_input, cfg,
                                                     "prefill-group"),
                    "decode_group": moe_layer_check(layer0, step_probe.first_input, cfg,
                                                    "decode-group")}
        if moe_line["prefill_group"]["dropped_pairs"] == 0:   # then a group that drops
            tight = cfg.replace(capacity_factor=cfg.capacity_factor / 4)
            moe_line["prefill_group_cf_quarter"] = moe_layer_check(
                layer0, pre_probe.first_input, tight, "prefill-group-cf-quarter")
    top = teach.topk(2, dim=-1).values
    ref = teach.argmax(-1)
    test = torch.where(live, fed, ref)
    if bool(clean.any()):
        noise = (dec[clean] - teach[clean]).abs().max().item()
        rule = margin_rule(f"archs[{cfg.name}]", [(ref[clean].cpu().numpy(),
                                                   (top[..., 0] - top[..., 1])[clean]
                                                   .cpu().numpy(),
                                                   test[clean].cpu().numpy())],
                           2 * noise + 1e-3)
    else:
        noise = None
        rule = {"rows": 0, "applied": False,
                "reason": "every row dropped a (token, choice) pair in the prefill or the "
                          "forward, whose groups differ: the forward is another function "
                          "there; the MoE layer check and fused = stepwise hold instead"}
    pre, step = attention_calls(cfg)
    if counts["flash_attention"] != pre or counts["decode_attention"] != step * (mnt - 1):
        raise AssertionError(f"archs[{cfg.name}]: launches {counts}, not {pre} flash a "
                             f"prefill and {step} decode a step")
    if not torch.isfinite(dec).all():
        raise AssertionError(f"archs[{cfg.name}]: non-finite logits")
    top_dec = dec.topk(2, dim=-1).values
    greedy = (toks, fed.cpu().numpy(), (top_dec[..., 0] - top_dec[..., 1]).cpu().numpy())
    line = {"batch": b, "prompt": s, "new_tokens": mnt, "generate_ms": generate_ms,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "flash_launches_per_generate": counts["flash_attention"],
            "decode_launches_per_step": counts["decode_attention"] / (mnt - 1),
            "kernel_launches": {k: v for k, v in counts.items() if v},
            "max_logit_diff_decode_vs_forward": noise, "margin_rule": rule,
            "mean_generated_length": float(np.mean(lengths))}
    if moe_line is not None:
        line["moe"] = moe_line
    return line, caches, greedy


def paths_check(phase: str, model, params, greedy, extra, seed: int):
    """A paged- and speculation-eligible stack through every other decode
    path, on ``generate_check``'s prompts (and prefix embeddings), whose
    dense greedy tokens are the reference: the paged Generator (paged
    decode), the speculative Generator (``spec_k=SPEC_K``, dense verify
    blocks) and the paged speculative one (paged verify blocks), each with
    drafts cut from the dense tokens at overlap 1.0 and 0.5, then a paged
    ``DecodeSession(slots=8)`` (paged decode) and a paged
    ``DecodeSession(slots=8, spec_k=SPEC_K)`` drained in chunks of SPEC_K
    with the plain tokens as drafts (paged verify blocks), both over the
    token prompts alone (held to plain greedy decode of them where the stack
    has prefix embeddings: a session takes none, as the reference's).
    Tokens are held under the margin rule at ``path_noise``'s tolerance.  A
    MoE stack's decode step of B tokens never drops a pair (C >= 8 >= its
    tokens) but a verify block of B x K tokens may, and a dropped pair
    changes its own token's output alone, so rows whose verify tokens
    dropped one are reported and left out of the rule.  No page may leak,
    and on the card each path's kernel must launch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.continuous import DecodeSession, leaked_pages
    from repro_torch.serving.generate import GenerateConfig, Generator
    from repro_torch.serving.sampler import SamplerConfig
    toks, ref, margins = greedy
    b, mnt = ref.shape
    name, vocab = model.cfg.name, model.cfg.vocab_size
    sampler = SamplerConfig(vocab_size=vocab)
    gcfg = GenerateConfig(max_new_tokens=mnt, sampler=sampler)
    paged = dict(paged=True, page_size=PAGE)
    runs = {"paged_generate": (paged, None)}
    want = {"paged_generate": "paged_decode_attention", "session": "paged_decode_attention",
            "spec_session": "paged_decode_attention_block"}
    for overlap in (1.0, 0.5):
        drafts = _overlap_drafts(ref, overlap, vocab)
        runs[f"spec_generate_{overlap}"] = (dict(spec_k=SPEC_K), drafts)
        runs[f"paged_spec_generate_{overlap}"] = (dict(paged, spec_k=SPEC_K), drafts)
        want[f"spec_generate_{overlap}"] = "decode_attention_block"
        want[f"paged_spec_generate_{overlap}"] = "paged_decode_attention_block"
    out = {}

    def hold(run_name, probe, ref_toks, ref_margins, got, rows):
        label = f"{phase}[{name}].{run_name}"
        if sum(probe.dropped(1)):
            raise AssertionError(f"{label}: a decode step dropped pairs")
        by_row = probe.dropped(SPEC_K) or [0] * 8      # per row (Generator) or slot
        clean = np.array([by_row[j] == 0 for j in rows])
        run = {"block_dropped_pairs_by_row": [by_row[j] for j in rows],
               "token_match": float((got == ref_toks).mean())}
        run["margin_rule"] = (margin_rule(label, [(ref_toks[clean], ref_margins[clean],
                                                   got[clean])], noise["tol"])
                              if clean.any() else
                              {"rows": 0, "applied": False,
                               "reason": "every row's verify tokens dropped a pair"})
        return run

    with torch.no_grad():
        noise = path_noise(model, params, sampler, toks, extra=extra)
        for run_name, (changes, drafts) in runs.items():
            gen = Generator(model, params, dataclasses.replace(gcfg, **changes))
            reset_launch_counts()
            t = time.perf_counter()
            with MoeProbe() as probe:
                got = gen.generate_with_lengths({"tokens": toks, **extra}, drafts=drafts)[0]
            _sync(toks.device)
            run = {"ms": (time.perf_counter() - t) * 1e3,
                   "launches": {k: v for k, v in launch_counts().items() if v}}
            if drafts is not None:
                run.update(gen.last_spec_stats, host_syncs=gen.last_spec_syncs)
            if gen.pool is not None and gen.pool.live_pages:
                raise AssertionError(f"{phase}[{name}].{run_name}: "
                                     f"{gen.pool.live_pages} pages leaked")
            run.update(hold(run_name, probe, ref, margins, got, list(range(b))))
            out[run_name] = run
        cap = toks.shape[1] + mnt + 1
        if extra:
            logits, caches = model.prefill(params, {"tokens": toks}, cap)
            plain, plain_margins = traced_greedy(model, params, sampler, logits, caches, mnt)
            del caches
        else:
            plain, plain_margins = ref, margins
        gen = Generator(model, params, dataclasses.replace(gcfg, **paged))
        for run_name, spec_k in (("session", 1), ("spec_session", SPEC_K)):
            reset_launch_counts()
            t = time.perf_counter()
            with MoeProbe() as probe:
                sess = DecodeSession(gen, slots=8, capacity=cap, seed=seed, spec_k=spec_k)
                slots = sess.admit(toks.cpu().numpy(), tags=list(range(b)),
                                   drafts=(plain, np.full(b, mnt, np.int32)) if spec_k > 1
                                   else None)
                done = sorted(sess.drain(chunk=SPEC_K if spec_k > 1 else 0),
                              key=lambda f: f["tag"])
            got = np.stack([f["tokens"] for f in done])
            stats = dict(sess.spec_stats) if spec_k > 1 else {}
            leaked = leaked_pages(sess) + sess.pool.live_pages
            if leaked:
                raise AssertionError(f"{phase}[{name}].{run_name}: {leaked} pages leaked")
            del sess
            _sync(toks.device)
            out[run_name] = {"ms": (time.perf_counter() - t) * 1e3,
                             "launches": {k: v for k, v in launch_counts().items() if v},
                             **stats, **hold(run_name, probe, plain, plain_margins, got,
                                             list(slots))}
    if toks.device.type == "cuda":
        for run_name, kernel in want.items():
            if not out[run_name]["launches"].get(kernel):
                raise AssertionError(f"{phase}[{name}].{run_name}: {kernel} never "
                                     f"launched: {out[run_name]['launches']}")
    out["path_noise"] = noise
    out["leaked_pages"] = 0
    return out


def smoke_stacks():
    """(label, config) of every smoke config the reference's CLIs, tests and
    contracts run (``configs.get_config(id, smoke=True)``, uncut), then the
    serve CLI's tiny stack's small model (its big model is the smoke paths'
    dh-16 G-2 shape too)."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.launch.serve import model_configs
    return ([(arch, get_config(arch, smoke=True)) for arch in ASSIGNED_ARCHS]
            + [("serve-tiny-small", model_configs("serve-tiny")[1])])


def smoke_paths_phase(seed: int, device=None):
    """Every stack of ``smoke_stacks`` on the card, random weights from the
    seed: ``SMOKE_BATCH`` prompts of ``SMOKE_PROMPT`` tokens and
    ``SMOKE_NEW`` greedy tokens through ``generate_check`` (dense decode,
    held to a teacher-forced forward under the margin rule, a launch a
    layer a step); a stack whose ``supports_paged_decode`` and
    ``supports_spec_decode`` hold also through ``paths_check`` (paged,
    speculative at overlap 1.0 and 0.5, paged speculative, a paged
    ``DecodeSession`` plain and speculative).  The recurrent, windowed and encoder-decoder stacks
    decode dense only, as their flags say."""
    import numpy as np
    import torch
    from repro_torch.launch.train import frontend_inputs
    from repro_torch.models import build_model
    dev = device or torch.device("cuda")
    t_phase = time.perf_counter()
    kernels = ("flash_attention", "decode_attention", "decode_attention_block",
               "paged_decode_attention", "paged_decode_attention_block")
    out, launches = {}, dict.fromkeys(kernels, 0)
    for i, (label, cfg) in enumerate(smoke_stacks()):
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 60 + i), dev)
        rng = np.random.default_rng(seed + 70 + i)
        extra = frontend_inputs(cfg, SMOKE_BATCH, rng, dev)
        eligible = model.supports_paged_decode and model.supports_spec_decode
        line = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.resolved_head_dim,
                "dtype": cfg.dtype, "paged_and_spec": eligible}
        line["dense"], _, greedy = generate_check(model, params, rng, SMOKE_BATCH, SMOKE_PROMPT,
                                                  SMOKE_NEW, extra)
        runs = [line["dense"]["kernel_launches"]]
        if eligible:
            line["paths"] = paths_check("smoke_paths", model, params, greedy, extra, seed)
            runs += [r["launches"] for r in line["paths"].values()
                     if isinstance(r, dict) and "launches" in r]
        for run in runs:
            for k in kernels:
                launches[k] += run.get(k, 0)
        line["seconds"] = time.perf_counter() - t0
        out[label] = line
        del params, model, greedy, extra
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"smoke_paths: a kernel never launched: {launches}")
    return {"phase": "smoke_paths", "seconds": time.perf_counter() - t_phase,
            "batch": SMOKE_BATCH, "prompt": SMOKE_PROMPT, "new_tokens": SMOKE_NEW,
            "configs": out, "launches": launches}


def _run_example(name: str, argv=()):
    """``python -m repro_torch.examples.<name> [argv]`` through ``runpy`` in
    this process (so its kernel launches are counted): (exit code, stdout
    lines, seconds, launches)."""
    import contextlib
    import io
    import runpy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out, saved = io.StringIO(), sys.argv
    module = f"repro_torch.examples.{name}"
    sys.modules.pop(module, None)     # run afresh as __main__, as ``-m`` does
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sys.argv = [f"python -m {module}", *argv]
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module(module, run_name="__main__")
                rc = 0
            except SystemExit as e:
                rc = e.code
    finally:
        sys.argv = saved
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"examples[{name}]: rc {rc}: {lines[-8:]}")
    return lines, time.perf_counter() - t0, {k: v for k, v in launch_counts().items() if v}


def _fields(line: str) -> dict:
    """``key=value`` pairs of a report line, values as numbers."""
    out = {}
    for word in line.replace(",", "").split():
        if "=" in word:
            k, v = word.split("=", 1)
            out[k] = float(v) if "." in v else int(v)
    return out


def examples_phase():
    """The three port examples on the card through their own entry points at
    the reference's defaults: ``quickstart`` (five queries, their routes),
    ``serve_e2e`` (two fp32 LMs pretrained 80 steps, the embedder 60, 120
    Poisson arrivals through the ``Scheduler`` at batch 8: every request
    completed or rejected, every dispatched row routed, the losses falling,
    the flash kernel and the dense decode kernel at head dim 24 (the small
    LM's) and 16 launched) and ``cache_policy_study`` (500 queries through
    FIFO, LRU and LFU banks of 96 rows).  Reports wall seconds, losses,
    routes, hit rates, cost ratio and launches."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    out = {}
    lines, secs, counts = _run_example("quickstart")
    routes = _fields(next(ln for ln in lines if ln.startswith("routing:")))
    decisions = [ln.split()[1] for ln in lines if ln.strip().startswith("sim=")]
    if len(decisions) != 5 or sum(routes.values()) != 5:
        raise AssertionError(f"examples[quickstart]: {lines}")
    out["quickstart"] = {"seconds": secs, "decisions": decisions, "routing": routes,
                         "cost": next(ln for ln in lines if ln.startswith("cost:")),
                         "kernel_launches": counts}
    by_dh, inner = {}, decode_ops.decode_attention

    def counted(q, *args):
        by_dh[q.shape[-1]] = by_dh.get(q.shape[-1], 0) + 1
        return inner(q, *args)

    decode_ops.decode_attention = counted
    try:
        lines, secs, counts = _run_example("serve_e2e")
    finally:
        decode_ops.decode_attention = inner
    losses = {ln.split(":")[0].strip(): [float(ln.split()[2]), float(ln.split()[4])]
              for ln in lines if ln.strip().startswith(("big-lm:", "small-lm:"))}
    info = next(ln for ln in lines if ln.strip().startswith("InfoNCE")).split()
    sched = _fields(next(ln for ln in lines if ln.startswith("scheduler:")))
    routes = _fields(next(ln for ln in lines if ln.startswith("routing:")))
    done = int(next(ln for ln in lines if ln.startswith("requests")).split()[1])
    queries = 120
    if done + sched["rejected"] != queries:
        raise AssertionError(f"examples[serve_e2e]: {done} completed + {sched['rejected']} "
                             f"rejected != {queries}")
    if routes["miss"] + routes["tweak"] + routes["exact"] != sched["dispatched"]:
        raise AssertionError(f"examples[serve_e2e]: routes {routes} do not cover the "
                             f"{sched['dispatched']} rows served")
    if any(last >= first for first, last in losses.values()) or len(losses) != 2:
        raise AssertionError(f"examples[serve_e2e]: a loss did not fall: {losses}")
    if not (counts.get("flash_attention") and by_dh.get(24) and by_dh.get(16)):
        raise AssertionError(f"examples[serve_e2e]: flash or the dh-24 / dh-16 dense decode "
                             f"never launched: {counts}, decode calls by dh {by_dh}")
    out["serve_e2e"] = {"seconds": secs, "argv": "--queries 120 --batch 8 --steps 80",
                        "lm_loss_first_last": losses,
                        "infonce_first_last": [float(info[1]), float(info[3])],
                        "completed": done, "scheduler": sched, "routing": routes,
                        "report": [ln for ln in lines if ln.split(" ")[0] in
                                   ("requests", "scheduler:", "routing:", "generated", "cost:")],
                        "decode_calls_by_head_dim": by_dh, "kernel_launches": counts}
    lines, secs, counts = _run_example("cache_policy_study")
    rates = {ln.split()[0].lower(): float(ln.split()[-1].rstrip("%")) / 100
             for ln in lines if "hit rate:" in ln}
    if sorted(rates) != ["fifo", "lfu", "lru"]:
        raise AssertionError(f"examples[cache_policy_study]: {lines}")
    out["cache_policy_study"] = {"seconds": secs, "queries": 500, "capacity": 96,
                                 "hit_rate": rates, "kernel_launches": counts}
    return {"phase": "examples", "examples": out}


def train_cli_check(arch: str, layers: int):
    """The train CLI's smoke run of ``arch`` on the card (``--steps 20``):
    exit 0 with the loss falling, ``layers`` flash launches a step (one an
    attention layer; an encoder-decoder's ``attention_calls``).  A
    multimodal id prints the reference's note line first."""
    import contextlib
    import io
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train as train_cli
    out = io.StringIO()
    n0 = flash_ops.launches
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--steps", "20", "--log-every", "10", "--arch", arch])
    launches = flash_ops.launches - n0
    lines = out.getvalue().strip().splitlines()
    notes = [line for line in lines if line.startswith("note: ")]
    lines = lines[len(notes):]
    if rc != 0 or not lines[0].startswith(f"arch={arch} "):
        raise AssertionError(f"archs[{arch}]: the train CLI returned {rc}: {lines}")
    if launches != 20 * layers:
        raise AssertionError(f"archs[{arch}]: the train CLI launched flash {launches} times, "
                             f"not {layers} a step for 20 steps")
    return {"rc": rc, "args": f"--steps 20 --log-every 10 --arch {arch} (its smoke config)",
            "flash_launches": launches, "notes": notes, "first_line": lines[0],
            "last_line": lines[-1]}


def archs_phase(seed: int, device=None):
    """The dense attention variants, the MoE stacks and the recurrent stacks
    at full width, one at a time on an emptied card, each freed before the
    next: random weights from seeds, depth cut as ``ARCHS`` says; a batch of
    ``ARCH_BATCH`` prompts of ``ARCH_PROMPT`` tokens and ``ARCH_NEW`` greedy
    tokens through ``generate_check``; for a sliding-window stack also
    ``RING``: prompts longer than its window, so prefill lays out the ring
    and decode wraps it further (the ring's positions, in the cache of the
    first windowed attention position of the pattern, are checked to be the
    last ``window`` ones); for ``MOE_PATHS_ARCH`` the paged and speculative
    paths (``paths_check``); for a frontend stack its stub input drawn
    from the seed (whisper's frames, internvl2's prefix embeddings) in every
    run, and for internvl2 the paged and speculative paths
    (``paths_check``); for a MoE, recurrent or frontend stack the
    train CLI's smoke run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import frontend_inputs
    from repro_torch.models import build_model
    from repro_torch.models.config import MAMBA2, MOE, RGLRU
    from repro_torch.models.transformer import KV_KINDS, RECURRENT, attention_layers
    from repro_torch.training.optimizer import tree_leaves
    dev = device or torch.device("cuda")
    t_phase = time.perf_counter()
    out, launches = {}, {"flash_attention": 0, "decode_attention": 0,
                         "decode_attention_block": 0, "paged_decode_attention": 0,
                         "paged_decode_attention_block": 0}
    for i, (arch, depth) in enumerate(ARCHS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()       # the kernel cases' inputs, kept till the end
        full = get_config(arch)
        cfg = full if depth is None else full.replace(num_layers=depth)
        t0 = time.perf_counter()
        model = build_model(cfg)
        with torch.no_grad():
            params = model.init(torch.Generator(device=dev).manual_seed(seed + 40 + i), dev)
        _sync(dev)
        leaves = tree_leaves(params)
        line = {"layers": cfg.num_layers, "layers_of": full.num_layers, "d_model": cfg.d_model,
                "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.resolved_head_dim,
                "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "window": cfg.sliding_window,
                "qkv_bias": cfg.qkv_bias, "mlp": cfg.mlp_type, "norm": cfg.norm_type,
                "dtype": cfg.dtype, "params": sum(p.numel() for p in leaves),
                "weight_gb": sum(p.numel() * p.element_size() for p in leaves) / 1e9,
                "init_s": time.perf_counter() - t0}
        # a decode step reads every weight, every expert included (the
        # reference's form runs all E), but of an untied embedding only its B
        # rows (a tied one is the head, read whole) and not the frontend's
        # projection (a prefill's); it reads and writes every recurrent state
        # once, and an encoder-decoder reads its cross K/V once a step
        emb = params["embed"]
        read = sum(p.numel() * p.element_size() for p in leaves)
        if not cfg.tie_embeddings:
            read -= (emb.shape[0] - ARCH_BATCH) * emb.shape[1] * emb.element_size()
        if "frontend_proj" in params:
            read -= params["frontend_proj"].numel() * params["frontend_proj"].element_size()
        state = model.init_caches(ARCH_BATCH, ARCH_PROMPT + ARCH_NEW + 1, "meta")
        size = lambda t: t.numel() * t.element_size()
        if model.is_encdec:
            state_rw = size(state["cross_k"]) + size(state["cross_v"])
        else:
            state_rw = 2 * sum(size(t) for c in state["scan"] + state["rem"]
                               for leaf, t in c.items() if leaf not in ("k", "v", "slot_pos"))
        del leaves, state
        rng = np.random.default_rng(seed + 50 + i)
        extra = frontend_inputs(cfg, ARCH_BATCH, rng, dev)
        line["short"], _, greedy = generate_check(model, params, rng, ARCH_BATCH, ARCH_PROMPT,
                                                  ARCH_NEW, extra)
        line["decode_step_weight_read_gb"] = read / 1e9
        line["decode_step_cross_kv_read_gb" if model.is_encdec
             else "decode_step_state_rw_gb"] = state_rw / 1e9
        line["decode_step_bound_ms"] = (read + state_rw) / HBM_BYTES_PER_S * 1e3
        if extra:
            line["frontend"] = {k: list(x.shape) for k, x in extra.items()}
            line.update(enc_layers=cfg.enc_layers, frontend_dim=cfg.frontend_dim,
                        prefix_tokens=cfg.num_prefix_tokens, tied=cfg.tie_embeddings)
        kinds = set(cfg.block_pattern) | set(cfg.pattern_remainder)
        if kinds & set(RECURRENT):
            line.update(pattern=list(cfg.block_pattern), remainder=list(cfg.pattern_remainder),
                        attention_layers=attention_layers(cfg))
            if MAMBA2 in kinds:
                line["ssm"] = {"heads": cfg.ssm_heads, "head_dim": cfg.ssm_head_dim,
                               "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
                               "d_inner": cfg.ssm_d_inner}
            if RGLRU in kinds:
                line["rnn_width"] = cfg.resolved_rnn_width
        runs = [line["short"]]
        if cfg.frontend == "vision_stub" or arch == MOE_PATHS_ARCH:
            line["paths"] = paths_check("archs", model, params, greedy, extra, seed)
            runs += [{"kernel_launches": r["launches"]} for r in line["paths"].values()
                     if isinstance(r, dict) and "launches" in r]
        if cfg.frontend == "vision_stub":
            line["kernel_cases"] = ARCH_KERNEL_CASES_OF[arch]
        elif model.is_encdec:
            line["kernel_cases"] = ARCH_KERNEL_CASES_OF[arch]
        del extra
        if "moe" in params.get("layers", [{}])[0]:
            line.update(experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
                        moe_d_ff=cfg.moe_d_ff, capacity_factor=cfg.capacity_factor,
                        dense_residual=cfg.moe_dense_residual,
                        group_size=cfg.moe_group_size)
            if arch != MOE_PATHS_ARCH:
                line["kernel_cases"] = ARCH_KERNEL_CASES_OF.get(arch)
        del greedy
        if cfg.sliding_window:
            rows, past, steps = RING
            prompt = cfg.sliding_window + past
            line["ring"], caches, _ = generate_check(model, params, rng, rows, prompt,
                                                     steps + 1)
            j = next(j for j, kind in enumerate(cfg.block_pattern) if kind in KV_KINDS)
            sp = caches["scan"][j]["slot_pos"]
            end = caches["pos"]
            cap = sp.shape[-1]
            if cap != cfg.sliding_window or not torch.equal(
                    sp.sort(-1).values, torch.arange(end - cap, end, device=dev, dtype=sp.dtype)
                    .expand_as(sp)):
                raise AssertionError(f"archs[{arch}]: the ring does not hold the last {cap} "
                                     f"positions before {end}")
            line["ring"].update(ring_slots=cap, last_pos=end - 1, ring_cache=f"scan[{j}]",
                                wraps=(end - 1) // cap, writes_past_prompt=end - prompt)
            runs.append(line["ring"])
            del caches
        for run in runs:
            for k in launches:
                launches[k] += run["kernel_launches"].get(k, 0)
        line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        line["memory_held_before_gb"] = held / 1e9
        del params, model
        torch.cuda.empty_cache()
        if cfg.block_pattern == (MOE,) or kinds & set(RECURRENT) or "frontend" in line:
            line["train_cli"] = train_cli_check(    # the train CLI's smoke run
                arch, attention_calls(get_config(arch, smoke=True))[0])
        line["seconds"] = time.perf_counter() - t0
        out[arch] = line
    return {"phase": "archs", "seconds": time.perf_counter() - t_phase, "configs": out,
            "launches": launches}


# the reference's assigned shapes the card runs (launch/shapes.py::INPUT_SHAPES)
# at its per-card batch; the other assigned ids take them in the meta sweep
SHAPE_CASES = (("llama-3.1-8b", "prefill_32k"), ("llama-3.1-8b", "decode_32k"),
               ("qwen2.5-3b", "train_4k"), ("h2o-danube-1.8b", "long_500k"),
               ("recurrentgemma-9b", "long_500k"), ("mamba2-130m", "long_500k"))


def shapes_phase(seed: int):
    """``SHAPE_CASES`` through ``launch.dryrun.run_one(..., device="cuda")``,
    one at a time on an emptied card: the dry-run's one-card plan, run.
    Prints a line a case and returns the phase line."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import attention_layers
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    out, launches = {}, {"flash_attention": 0, "decode_attention": 0}
    for arch, shape in SHAPE_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, device="cuda", seed=seed)
        counts = kernels.launch_counts()
        name = f"{arch}/{shape}"
        if rec["status"] != "ok":
            raise AssertionError(f"shapes[{name}]: {rec.get('error', rec.get('reason'))}")
        card, plan = rec["card"], rec["one_card"]
        if card["max_memory_allocated"] >= dryrun.CARD_BYTES:
            raise AssertionError(f"shapes[{name}]: {card['max_memory_allocated']} bytes "
                                 f"allocated at the peak, not under {dryrun.CARD_BYTES}")
        cfg = get_config(arch)
        want = ("flash_attention" if rec["kind"] != "decode" else "decode_attention"
                if attention_layers(cfg) else None)
        if want and not counts[want]:
            raise AssertionError(f"shapes[{name}]: {want} was not launched")
        for k in launches:
            launches[k] += counts[k]
        line = {"shape_case": name, "kind": rec["kind"], "seq_len": rec["seq_len"],
                "batch": plan["batch"], "microbatches": plan["microbatches"],
                "layers": plan["layers"], "full_layers": plan["full_layers"],
                "held_gb": plan["held_bytes"] / 1e9, "budget_gb": plan["budget_bytes"] / 1e9,
                "ms_per_step": card["ms_per_step"], "ms_first": card.get("ms_first"),
                "peak_gb": card["max_memory_allocated"] / 1e9,
                "reckoned_peak_gb": plan["peak_bytes"] / 1e9,
                "peak_over_reckoned": card["max_memory_allocated"] / plan["peak_bytes"],
                "flops_step": plan["flops"],
                "tflops_per_s": plan["flops"] / card["ms_per_step"] / 1e9,
                "flops_full_depth": rec["flops"], "peak_full_depth_gb": rec["peak_bytes"] / 1e9,
                "launches": {k: v for k, v in counts.items() if v},
                "collectives_16x16": rec["collectives"],
                "collectives_body_once_16x16": rec["collectives_body_once"],
                "loop_trip_count": rec["loop_trip_count"],
                "collectives_gb_16x16": sum(rec["collectives"].values()) / 1e9,
                "reckon_s": rec["reckon_s"], "seconds": time.perf_counter() - t0}
        for key in ("ms_steps", "bitwise_repeat", "pos", "losses"):
            if key in card:
                line[key] = card[key]
        print(json.dumps(line), flush=True)
        out[name] = line
        del rec
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "shapes", "seconds": time.perf_counter() - t_phase, "cases": out,
            "launches": launches, "card_bytes": dryrun.CARD_BYTES, "headroom": dryrun.HEADROOM}


def shape_kernel_cases(gen):
    """The flash and decode kernels at the shapes the ``shapes`` phase
    drives: llama-3.1-8b's 32,768-token prefill (B 2, H 32 / 8, dh 128) held
    on row slices, qwen2.5-3b's microbatch of 4 x 4,096 (H 16 / 2), the
    dense decode over 32,769 live slots of 33,024 (B 8, one layer's cache:
    1.1 GB, far past the L2), and the rings at position 524,288 (B 1):
    danube's 4,096 slots at dh 80 over its 24 layers, recurrentgemma's
    2,048 at dh 256 (G 16) over its 12 attention layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import INPUT_SHAPES, decode_capacity
    from repro_torch.models.transformer import attention_layers
    llama, qwen = get_config("llama-3.1-8b"), get_config("qwen2.5-3b")
    s32, s4 = INPUT_SHAPES["prefill_32k"][0], INPUT_SHAPES["train_4k"][0]
    cases = [
        flash_rows_case("prefill-32k", 2, s32, llama.num_heads, llama.num_kv_heads,
                        llama.resolved_head_dim, llama.flash_block_k, gen),
        flash_rows_case("train-4k", 4, s4, qwen.num_heads, qwen.num_kv_heads,
                        qwen.resolved_head_dim, qwen.flash_block_k, gen),
        decode_case("decode-32k", 8, llama.num_heads, llama.num_kv_heads,
                    llama.resolved_head_dim, decode_capacity(INPUT_SHAPES["decode_32k"][0]),
                    INPUT_SHAPES["decode_32k"][0] + 1, 1, gen),
    ]
    for arch, label in (("h2o-danube-1.8b", "danube-ring-500k"),
                        ("recurrentgemma-9b", "rg-ring-500k")):
        cfg = get_config(arch)
        w = cfg.sliding_window
        cases.append(decode_case(label, 1, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, w, w, attention_layers(cfg), gen))
    return cases


def serve_cli_phase():
    """``python -m repro_torch.launch.serve`` with no arguments, as a user runs
    it (``runpy``, what ``-m`` runs, in this process so that its kernel
    launches are counted): the tiny fp32 stack (head dim 16) on the card,
    200 queries; it must exit 0 with every request completed and launch the
    flash, decode and lookup kernels."""
    import contextlib
    import io
    import runpy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out, argv = io.StringIO(), sys.argv
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sys.argv = ["python -m repro_torch.launch.serve"]
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module("repro_torch.launch.serve", run_name="__main__")
                rc = 0
            except SystemExit as e:
                rc = e.code
    finally:
        sys.argv = argv
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    lines = out.getvalue().strip().splitlines()
    done = [ln for ln in lines if ln.startswith("requests:")]
    n = int(done[0].split()[1]) if done else -1
    if rc != 0 or n != SERVE_CLI_QUERIES or "on cuda" not in done[0]:
        raise AssertionError(f"serve_cli: rc {rc}, completions {n}: {lines[-8:]}")
    if min(counts[k] for k in ("flash_attention", "decode_attention", "cosine_topk")) == 0:
        raise AssertionError(f"serve_cli: a kernel of the path never launched: {counts}")
    return {"phase": "serve_cli", "argv": "python -m repro_torch.launch.serve", "rc": rc,
            "seconds": seconds, "requests": n,
            "kernel_launches": {k: v for k, v in counts.items() if v},
            "report": [ln for ln in lines if ln.split(":")[0] in
                       ("requests", "scheduler", "routing", "tokens", "cost")]}


def plan_traffic(stack, device, seed: int, n_pop: int, n_batches: int, bsz: int):
    """Populated pairs, serve batches and the router threshold.

    TWEAK traffic is one-word edits of populated queries and the threshold
    sits in the gap between the edits' similarity to their populated partner
    and the fresh queries' best similarity to anything populated, both
    measured with the stack's own (trained) embedder.  Also returns the
    populated ``Query`` objects (topic and intent) for the baseline phase.
    """
    import numpy as np
    import torch
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.data import QuestionPairGenerator, synthesize_response
    from repro_torch.models.embedder import encode
    from repro_torch.serving.batcher import pad_to_buckets

    g = QuestionPairGenerator(seed=seed)
    pop = [g._random_query() for _ in range(n_pop)]
    fresh = [g._random_query().text for _ in range(4 * n_batches * bsz)]
    edits = [q.text + " please" for q in pop]
    eparams, ecfg, tok = stack["embedder_params"], stack["embedder_cfg"], stack["tokenizer"]

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
    return pairs, batches, calib, pop


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
    (serve line, launches, engine, one more planned batch for the profile).
    The stack is ``build_stack``'s default, so its embedder is trained (60
    steps, batch 16) before the traffic is planned on it."""
    import torch
    from repro_torch.core.engine import TweakLLMEngine
    from repro_torch.core.router import RouterConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_stack, model_configs

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stack = build_stack(model=model, device=device, seed=seed)
    _sync(device)
    train_s = time.perf_counter() - t0
    pairs, planned, calib, pop = plan_traffic(stack, device, seed, n_pop, n_batches + 1, bsz)
    batches, spare = planned[:-1], planned[-1]
    eng = TweakLLMEngine(**dict(stack, router_cfg=RouterConfig(
        tweak_threshold=calib["threshold"])))
    n_fill = eng.cache_cfg.capacity - 4 * n_pop - (n_batches + 1) * bsz
    fill_bank(eng, n_fill, seed)
    eng.populate(*pairs)
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0

    reset_launch_counts()          # the main path starts here ...
    lat, real_new, results = [], 0, []
    with torch.no_grad():
        for batch in batches:
            t = time.perf_counter()
            res = eng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
            real_new += res.big_tokens + res.small_tokens
            results.append(res)
            if len(res.responses) != len(batch) or not all(
                    isinstance(r, str) for r in res.responses):
                raise AssertionError("handle_batch returned malformed responses")
    launches = launch_counts()     # ... and ends here
    s = eng.stats
    n = n_batches * bsz
    _check_stats("serve", s, n, max_new_tokens)
    if real_new != s.big_tokens + s.small_tokens:
        raise AssertionError(f"batch token counts disagree with EngineStats: {s}")
    if eng.device.type == "cuda" and min(launches[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"a kernel was not launched by the serve path: {launches}")
    with torch.no_grad():
        pick = list(eng.bank.text_store.items())[:bsz]
        reuse = prefix_reuse_check(
            eng, [q + " please" for _, (q, _) in pick], [c for _, c in pick], max_new_tokens)
    big, small, _, _ = model_configs(model)
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
           "setup_s": setup_s, "build_stack_s": train_s, "embedder_train_steps": 60,
           "launches": launches,
           "prefix_reuse": reuse}
    if eng.device.type == "cuda":
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    plan = (pairs, batches, n_fill, seed, calib["threshold"], pop)
    return row, launches, eng, spare, plan, results


# ------------------------------------------------------------------ slice 2
# Paged and speculative decode run other kernels than the dense path, so on
# the card their greedy tokens may leave the dense path's where two logits
# are within rounding of each other.  The margin rule: a row may diverge
# only at a token whose top-2 logit margin on the reference (dense, plain)
# path is at most twice the largest logit difference measured between the
# two paths on identical inputs (``path_noise``), plus 1e-3.

class MarginModel:
    """A Model proxy that records the top-2 margin of the vocab-masked logits
    each greedy token comes from (prefill, then every decode step) during a
    generate call; everything else goes to the model."""

    def __init__(self, inner, sampler):
        self._inner, self._sampler, self.steps = inner, sampler, []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _note(self, logits):
        from repro_torch.serving.sampler import mask_vocab
        top = mask_vocab(logits, self._sampler).topk(2, dim=-1).values
        self.steps.append(top[..., 0] - top[..., 1])

    def prefill(self, params, batch, capacity):
        self.steps = []
        logits, caches = self._inner.prefill(params, batch, capacity)
        self._note(logits)
        return logits, caches

    def prefill_with_prefix(self, params, batch, capacity, prefix):
        self.steps = []
        logits, caches = self._inner.prefill_with_prefix(params, batch, capacity, prefix)
        self._note(logits)
        return logits, caches

    def decode_step(self, params, token, caches):
        logits, caches = self._inner.decode_step(params, token, caches)
        self._note(logits)
        return logits, caches


def record_calls(gen):
    """Keep (tokens, margins or None) of every generate call of ``gen``."""
    import torch
    calls, inner = [], gen.generate_with_lengths

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        m = gen.model.steps if isinstance(gen.model, MarginModel) else None
        calls.append((out[0].copy(), None if m is None else
                      torch.stack(m, 1).float().cpu().numpy()))
        return out

    gen.generate_with_lengths = wrapped
    return calls


def margin_rule(name: str, pairs, tol: float):
    """Hold test tokens to reference tokens under the margin rule.  ``pairs``
    holds (reference tokens (B,T), reference margins (B,T), test tokens)."""
    import numpy as np
    rows = equal = 0
    match, diverged = [], []
    for ref, margins, test in pairs:
        n = min(ref.shape[1], test.shape[1])
        match.append((ref[:, :n] == test[:, :n]).ravel())
        for b in range(ref.shape[0]):
            rows += 1
            diff = np.flatnonzero(ref[b, :n] != test[b, :n])
            if diff.size == 0:
                equal += 1
                continue
            d = int(diff[0])
            m = float(margins[b, d])
            diverged.append([b, d, m])
            if not m <= tol:
                raise AssertionError(
                    f"{name}: row {b} leaves the reference at token {d}, where the "
                    f"reference's top-2 logit margin {m} exceeds the rule's {tol}")
    return {"rows": rows, "rows_equal": equal,
            "token_match": float(np.concatenate(match).mean()),
            "diverged": diverged[:8], "n_diverged": len(diverged), "tol": tol}


def traced_greedy(model, params, sampler, logits, caches, mnt: int):
    """Plain greedy decode step by step from a prefill: tokens (B, mnt) and
    the top-2 margin of the logits each token came from, on the host."""
    import torch
    from repro_torch.serving.sampler import greedy_ids, mask_vocab
    toks, margins = [], []
    for j in range(mnt):
        masked = mask_vocab(logits, sampler)
        top = masked.topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        toks.append(greedy_ids(masked))
        if j + 1 < mnt:
            logits, caches = model.decode_step(params, toks[-1], caches)
    return (torch.stack(toks, 1).cpu().numpy(),
            torch.stack(margins, 1).float().cpu().numpy())


def path_noise(model, params, sampler, tokens, steps: int = SPEC_K, extra=None):
    """Largest |logit difference| between the dense decode step and the paged
    step, a dense verify block of ``steps`` and a paged one, all fed the
    dense path's greedy tokens from one prefill (computed, then discarded),
    at the batch of ``tokens`` and at every smaller batch bucket down to 1
    (cuBLAS may reduce in another order at another row count); ``tol`` is
    the margin rule's: twice the largest, plus 1e-3.  ``extra`` holds the
    prefix embeddings of a frontend stack, cut to each bucket."""
    out = {}
    b = tokens.shape[0]
    while b >= 1:
        cut = {k: x[:b] for k, x in (extra or {}).items()}
        for k, v in _path_noise_at(model, params, sampler, tokens[:b], steps, cut).items():
            out[f"{k}_b{b}"] = v
        b //= 2
    out["tol"] = 2 * max(out.values()) + 1e-3
    return out


def _path_noise_at(model, params, sampler, tokens, steps, extra):
    import torch
    from repro_torch.serving import paged_kv
    from repro_torch.serving.sampler import greedy_ids, mask_vocab
    b, s = tokens.shape
    pre = extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra else 0
    cap = pre + s + steps + 2
    vocab = sampler.vocab_size or model.cfg.vocab_size
    batch = {"tokens": tokens, **extra}

    def paged(caches):
        pool = paged_kv.PagePool(model, paged_kv.PagePoolConfig(PAGE, b * -(-cap // PAGE)),
                                 tokens.device)
        tbl, wr = pool.alloc_block_table(b, cap)
        return paged_kv.pack_caches(pool.storage, caches,
                                    torch.as_tensor(tbl, device=tokens.device),
                                    torch.as_tensor(wr, device=tokens.device))

    logits, caches = model.prefill(params, batch, cap)
    fed = [greedy_ids(mask_vocab(logits, sampler))]
    dense = []
    for _ in range(steps):
        logits, caches = model.decode_step(params, fed[-1], caches)
        dense.append(logits[..., :vocab].float())
        fed.append(greedy_ids(mask_vocab(logits, sampler)))
    dense = torch.stack(dense, 1)                                   # (B,steps,V)
    out = {}
    pc = paged(model.prefill(params, batch, cap)[1])
    got = []
    for j in range(steps):
        logits, pc = model.decode_step(params, fed[j], pc)
        got.append(logits[..., :vocab].float())
    out["paged_step"] = (torch.stack(got, 1) - dense).abs().max().item()
    block = torch.stack(fed[:steps], 1)
    dc = paged_kv.row_pos_caches(model.prefill(params, batch, cap)[1], b)
    out["dense_block"] = (model.decode_block(params, block, dc)[0][..., :vocab].float()
                          - dense).abs().max().item()
    pc = paged(model.prefill(params, batch, cap)[1])
    out["paged_block"] = (model.decode_block(params, block, pc)[0][..., :vocab].float()
                          - dense).abs().max().item()
    return out


def response_ids(text):
    """Token ids of a generated response: the tokenizer renders id i as
    ``w<i>`` and the special ids by name."""
    from repro_torch.tokenizer.tokenizer import SPECIAL_TOKENS
    return [SPECIAL_TOKENS[w[1:-1]] if w.startswith("<") else int(w[1:])
            for w in text.split()]


def _gen_like(gen, model=None, **changes):
    """A Generator on ``gen``'s parameters (no copy) with changed settings."""
    import dataclasses
    from repro_torch.serving.generate import Generator
    return Generator(model or gen.model, gen.params, dataclasses.replace(gen.cfg, **changes))


def _engine_like(eng, big, small, threshold):
    from repro_torch.core.engine import TweakLLMEngine
    from repro_torch.core.router import RouterConfig
    return TweakLLMEngine(tokenizer=eng.tok, embedder_params=eng.embedder_params,
                          embedder_cfg=eng.embedder_cfg, big=big, small=small,
                          cache_cfg=eng.cache_cfg,
                          router_cfg=RouterConfig(tweak_threshold=threshold))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _serve(eng, batches, max_new_tokens):
    import torch
    lat, out = [], []
    with torch.no_grad():
        for batch in batches:
            t = time.perf_counter()
            res = eng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
            _sync(eng.device)
            lat.append((time.perf_counter() - t) * 1e3)
            out.append(res)
    return lat, out


def _check_stats(name, s, n, max_new_tokens):
    if min(s.exact, s.tweak, s.miss) == 0:
        raise AssertionError(f"{name}: not every route was taken: {s}")
    if s.total != n or s.exact + s.tweak + s.miss != n:
        raise AssertionError(f"{name}: EngineStats inconsistent: {s}")
    if not s.big_tokens + s.small_tokens <= n * max_new_tokens:
        raise AssertionError(f"{name}: generated tokens exceed queries x budget: {s}")


def paged_phase(eng, plan, serve_out, max_new_tokens: int, noise):
    """The serve traffic through an engine whose generators are paged, on the
    serve phase's weights, against a dense engine on the same weights whose
    generators record their margins; both start from the serve phase's bank.
    Returns (paged line, the paged engine, the dense engine's recorded
    generate calls: (tokens, margins) per call, big and small)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.continuous import leaked_pages
    pairs, batches, n_fill, seed, threshold, _ = plan
    sampler = eng.small.cfg.sampler
    ref = {k: _gen_like(getattr(eng, k), MarginModel(getattr(eng, k).model, sampler))
           for k in ("big", "small")}
    deng = _engine_like(eng, ref["big"], ref["small"], threshold)
    peng = _engine_like(eng, *(_gen_like(getattr(eng, k), paged=True, page_size=PAGE,
                                         pool_pages=POOL_PAGES) for k in ("big", "small")),
                        threshold)
    calls = {}
    for name, e in (("dense", deng), ("paged", peng)):
        fill_bank(e, n_fill, seed)
        e.populate(*pairs)
        calls[name] = {k: record_calls(getattr(e, k)) for k in ("big", "small")}
    _sync(eng.device)
    dense_lat, dense_res = _serve(deng, batches, max_new_tokens)
    reset_launch_counts()          # the paged path starts here ...
    lat, res = _serve(peng, batches, max_new_tokens)
    launches = launch_counts()     # ... and ends here
    n = len(batches) * len(batches[0])
    _check_stats("paged", peng.stats, n, max_new_tokens)
    if eng.device.type == "cuda" and launches["paged_decode_attention"] == 0:
        raise AssertionError(f"paged decode never launched its kernel: {launches}")
    decisions = lambda rs: [[m["decision"] for m in r.meta] for r in rs]
    if decisions(res) != decisions(serve_out) or decisions(dense_res) != decisions(serve_out):
        raise AssertionError("routes differ from the serve phase's on the same batches")
    leaked = leaked_pages(peng.big, peng.small)
    if leaked:
        raise AssertionError(f"paged engine leaked {leaked} pages")
    if any(len(calls["dense"][k]) != len(calls["paged"][k]) for k in ("big", "small")):
        raise AssertionError("the paged engine made other generate calls than the dense one")
    rule = {k: margin_rule(f"paged {k}", [(r[0], r[1], p[0]) for r, p in
                                          zip(calls["dense"][k], calls["paged"][k])],
                           noise[k]["tol"]) for k in ("big", "small")}
    same_as_serve = sum(a.responses == b.responses for a, b in zip(dense_res, serve_out))
    s = peng.stats
    row = {"phase": "paged", "page_size": PAGE, "pool_pages": POOL_PAGES,
           "routes": {"exact": s.exact, "tweak": s.tweak, "miss": s.miss},
           "big_tokens": s.big_tokens, "small_tokens": s.small_tokens,
           "batch_ms": lat, "steady_batch_ms_mean": sum(lat[1:]) / max(len(lat) - 1, 1),
           "dense_recorded_batch_ms": dense_lat, "launches": launches,
           "margin_rule": rule, "path_noise": noise,
           "dense_rerun_equals_serve_batches": same_as_serve, "leaked_pages": leaked,
           "pinned_pages": peng.small.pool.pinned_pages,
           "pool_live_pages_after": peng.small.pool.live_pages}
    return row, peng, calls["dense"]


def _overlap_drafts(ref, overlap: float, vocab: int):
    """Drafts from a plain run's own greedy output ``ref``: the first
    ``overlap`` share kept, the tail rewritten so that it never matches."""
    import numpy as np
    ids = ref.copy()
    keep = int(round(overlap * ref.shape[1]))
    ids[:, keep:] = (ref[:, keep:] + 1 - 5) % (vocab - 5) + 5
    return ids, np.full(ref.shape[0], ref.shape[1], np.int32)


def spec_phase(eng, peng, batch, max_new_tokens: int, noise):
    """Speculation on the TWEAK route.  Generator level: a TWEAK batch over
    the shared prefix, plain and speculating (k 4), dense and paged, drafts
    at overlap 1.0 / 0.5 / 0.0 of the same path's plain greedy tokens (the
    paged path's may leave the dense path's at a near-tie); engine level:
    the paged engine with a speculating small generator, drafts from
    ``draft_store``.  Each generator-level run is timed twice, the second
    time in reverse order."""
    import torch
    from repro_torch.core import tweak as tweak_lib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batcher import bucket_len, pad_to_buckets
    from repro_torch.serving.continuous import leaked_pages
    small = eng.small
    sampler, vocab = small.cfg.sampler, small.model.cfg.vocab_size
    pick = list(eng.bank.text_store.items())[:8]
    st, sm = tweak_lib.build_tweak_suffix_batch(
        eng.tok, [q + " please" for _, (q, _) in pick], [q for _, (q, _) in pick],
        [r for _, (_, r) in pick], 1024)
    width = bucket_len(int(sm.sum(1).max()))
    st = pad_to_buckets(st[:, :width], sm[:, :width])[0]
    pc = small.build_prefix_cache(tweak_lib.tweak_prefix_ids(eng.tok), st.shape[0])
    cap = pc.length + st.shape[1] + max_new_tokens + 1
    with torch.no_grad():
        logits, caches = small.model.prefill_with_prefix(
            small.params, {"tokens": torch.as_tensor(st, device=eng.device).long()}, cap,
            pc.caches)
        ref, margins = traced_greedy(small.model, small.params, sampler, logits, caches,
                                     max_new_tokens)
    gens = {"plain-dense": _gen_like(small),
            "plain-paged": _gen_like(small, paged=True, page_size=PAGE, pool_pages=POOL_PAGES),
            "spec-dense": _gen_like(small, spec_k=SPEC_K),
            "spec-paged": _gen_like(small, spec_k=SPEC_K, paged=True, page_size=PAGE,
                                    pool_pages=POOL_PAGES)}
    runs = [("plain-dense", None), ("plain-paged", None)]
    for kind in ("spec-dense", "spec-paged"):
        runs += [(kind, ov) for ov in (1.0, 0.5, 0.0)]
    own = {"spec-dense": ref}      # each path's drafts: its own plain greedy tokens
    call = lambda name, ov: gens[name].generate_with_lengths(
        {"tokens": st}, max_new_tokens=max_new_tokens, seed=0, prefix_cache=pc,
        drafts=None if ov is None else _overlap_drafts(own[name], ov, vocab))
    reset_launch_counts()          # the speculative paths start here ...
    with torch.no_grad():
        own["spec-paged"] = call("plain-paged", None)[0]
        for name in gens:          # warm each generator once (pool, pins)
            call(name, None if name.startswith("plain") else 0.0)
        out = {run: {"run": run[0], "overlap": run[1], "ms": []} for run in runs}
        for order in (runs, runs[::-1]):
            for name, ov in order:
                _sync(eng.device)
                t = time.perf_counter()
                toks = call(name, ov)[0]
                row = out[(name, ov)]
                row["ms"].append((time.perf_counter() - t) * 1e3)
                g = gens[name]
                row["tokens"] = margin_rule(f"spec {name} {ov}", [(ref, margins, toks)],
                                            noise["tol"])
                if ov is not None:
                    row.update(g.last_spec_stats, host_syncs=g.last_spec_syncs,
                               verify_iterations=g.last_spec_stats["spec_steps"])
        out = list(out.values())
        gen_launches = launch_counts()
        # engine level: a plain pass of the paged engine whose small model
        # records its margins, then the same batch with a speculating small
        # generator and drafts that ``draft_store`` takes from the plain pass
        plain = _gen_like(peng.small, MarginModel(peng.small.model, sampler))
        spec_gen = _gen_like(peng.small, spec_k=SPEC_K)
        calls = {"plain": record_calls(plain), "spec": record_calls(spec_gen)}
        peng.small = plain
        first = peng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
        slot_of = {q: s for s, (q, _) in peng.bank.text_store.items()}
        tweak_rows = [i for i, m in enumerate(first.meta) if m["decision"] == 1]
        for i in tweak_rows:       # an edit "<populated query> please" hits its source
            src = tweak_lib.preprocess_query(batch[i][:-len(" please")])
            peng.bank.draft_store[slot_of[src]] = response_ids(first.responses[i])
        peng.small = spec_gen
        before = (peng.stats.proposed, peng.stats.accepted, peng.stats.spec_steps)
        _sync(eng.device)
        t = time.perf_counter()
        second = peng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
        _sync(eng.device)
        engine_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()     # ... and end here
    s = peng.stats
    if len(calls["plain"]) != len(calls["spec"]):
        raise AssertionError("the speculating pass made other generate calls than the plain one")
    eng_spec = {"proposed": s.proposed - before[0], "accepted": s.accepted - before[1],
                "spec_steps": s.spec_steps - before[2], "tweak_rows": len(tweak_rows),
                "batch_ms": engine_ms, "acceptance_rate": s.acceptance_rate,
                "tokens": margin_rule("engine spec", [(p[0], p[1], q[0]) for p, q in
                                                      zip(calls["plain"], calls["spec"])],
                                      noise["tol"]),
                "calls": [int(c[0].shape[0]) for c in calls["plain"]]}
    if not tweak_rows or eng_spec["proposed"] <= 0:
        raise AssertionError(f"engine-level speculation proposed nothing: {eng_spec}")
    if [m["decision"] for m in first.meta] != [m["decision"] for m in second.meta]:
        raise AssertionError("routes changed between the two speculating passes")
    for k in ("decode_attention_block", "paged_decode_attention_block"):
        if eng.device.type == "cuda" and launches[k] == 0:
            raise AssertionError(f"the speculative paths never launched {k}: {launches}")
    for r in out:
        if r["overlap"] == 1.0 and r["accepted"] <= 0:
            raise AssertionError(f"a perfect draft was not accepted: {r}")
    leaked = leaked_pages(*gens.values(), plain, spec_gen, peng.big)
    if leaked:
        raise AssertionError(f"speculation leaked {leaked} pages")
    return {"phase": "spec", "spec_k": SPEC_K, "batch": int(st.shape[0]),
            "suffix_width": int(st.shape[1]), "prefix_len": pc.length,
            "max_new_tokens": max_new_tokens, "runs": out, "engine": eng_spec,
            "generator_launches": gen_launches, "launches": launches, "path_noise": noise,
            "leaked_pages": leaked}


def session_phase(eng, texts, max_new_tokens: int, seed: int, noise):
    """``DecodeSession(slots=8)`` on the big model at full width, paged: the
    inaugural cohort against the dense greedy path under the margin rule,
    then join and leave mid-flight, then zero leaked pages."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batcher import pad_to_buckets
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.serving.continuous import DecodeSession, leaked_pages
    big = eng.big
    toks, mask = eng.tok.encode_batch([preprocess_query(q) for q in texts[:12]],
                                      eng.max_query_len)
    toks = pad_to_buckets(toks, mask)[0][:12]                # (12, 16)
    cap = toks.shape[1] + max_new_tokens + 1
    dev_toks = torch.as_tensor(toks, device=eng.device).long()
    with torch.no_grad():
        logits, caches = big.model.prefill(big.params, {"tokens": dev_toks[:8]}, cap)
        ref, margins = traced_greedy(big.model, big.params, big.cfg.sampler, logits, caches,
                                     max_new_tokens)
    gen = _gen_like(big, paged=True, page_size=PAGE, max_new_tokens=max_new_tokens)
    reset_launch_counts()          # the session path starts here ...
    with torch.no_grad():
        sess = DecodeSession(gen, slots=8, capacity=cap, seed=seed)
        t = time.perf_counter()
        sess.admit(toks[:8], tags=list(range(8)))
        first = sorted(sess.drain(), key=lambda f: f["tag"])
        inaugural_ms = (time.perf_counter() - t) * 1e3
        got = np.stack([f["tokens"] for f in first])
        rule = margin_rule("session inaugural", [(ref, margins, got)], noise["tol"])
        # join and leave mid-flight: cohorts of 4 join at steps 0, j and
        # max_new_tokens (j = 10 of 32); each leaves once it has its budget
        j = max_new_tokens // 3
        t = time.perf_counter()
        sess.admit(toks[:4], tags=["a0", "a1", "a2", "a3"])
        sess.run_chunk(j)
        sess.admit(toks[8:12], tags=["b0", "b1", "b2", "b3"])
        sess.run_chunk(max_new_tokens - j)
        harvest1 = sess.harvest()
        sess.admit(toks[4:8], tags=["c0", "c1", "c2", "c3"])
        sess.run_chunk(j)
        harvest2 = sess.harvest()
        done = harvest1 + harvest2 + sess.drain()
        churn_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()     # ... and ends here
    if eng.device.type == "cuda" and launches["paged_decode_attention"] == 0:
        raise AssertionError(f"the session never launched the paged kernel: {launches}")
    tags = [f["tag"] for f in done]
    if (len(set(tags)) != 12 or not {"a0", "a1", "a2", "a3"} <= {f["tag"] for f in harvest1}
            or any(f["tag"][0] == "c" for f in harvest1 + harvest2)):
        raise AssertionError(f"rows left the session out of order: {tags}")
    if any(f["length"] != max_new_tokens and not f["ended"] for f in done):
        raise AssertionError("a harvested row stopped short of its budget")
    by_tag = sorted(done, key=lambda f: f["tag"])
    a_rows = np.stack([f["tokens"] for f in by_tag if f["tag"][0] == "a"])
    c_rows = np.stack([f["tokens"] for f in by_tag if f["tag"][0] == "c"])
    joined = margin_rule("session mid-flight", [(ref[:4], margins[:4], a_rows),
                                                (ref[4:8], margins[4:8], c_rows)],
                         noise["tol"])
    leaked = leaked_pages(sess)
    if leaked or sess.pool.live_pages:
        raise AssertionError(f"the session leaked {leaked} pages")
    del sess
    spec = spec_session(gen, toks, cap, got, ref, margins, max_new_tokens, seed, noise)
    return {"phase": "session", "slots": 8, "capacity": cap, "model": big.model.cfg.name,
            "max_new_tokens": max_new_tokens, "inaugural": rule, "inaugural_ms": inaugural_ms,
            "mid_flight": joined, "churn_rows": len(done), "churn_ms": churn_ms,
            "launches": launches, "leaked_pages": leaked, "path_noise": noise, "spec": spec}


def spec_session(gen, toks, cap, plain, ref, margins, max_new_tokens: int, seed: int, noise):
    """``DecodeSession(slots=8, spec_k=SPEC_K)`` on the big model, paged:
    drafts cut from the plain session's own inaugural tokens ``plain`` at
    overlap 1.0 / 0.5 / 0.0, each cohort drained in chunks of SPEC_K verify
    blocks (one harvest a chunk); then a cohort of 4 with drafts joins two
    blocks after another.  Tokens are held to the dense greedy reference
    ``ref`` under the margin rule (verify blocks round as the paged verify
    kernel does); at overlap 1.0 the session runs fewer verify blocks with
    a speculating row than the plain session's decode steps; the paged
    verify kernel launches; no page leaks."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.continuous import DecodeSession, leaked_pages
    vocab = gen.model.cfg.vocab_size
    runs = {}
    reset_launch_counts()          # the spec-session path starts here ...
    with torch.no_grad():
        for overlap in (1.0, 0.5, 0.0):
            drafts = _overlap_drafts(plain, overlap, vocab)
            sess = DecodeSession(gen, slots=8, capacity=cap, seed=seed, spec_k=SPEC_K)
            _sync(gen.device)
            t = time.perf_counter()
            sess.admit(toks[:8], tags=list(range(8)), drafts=drafts)
            out = sorted(sess.drain(chunk=SPEC_K), key=lambda f: f["tag"])
            ms = (time.perf_counter() - t) * 1e3
            got = np.stack([f["tokens"] for f in out])
            runs[str(overlap)] = dict(
                ms=ms, **sess.spec_stats, equal_to_plain_session=float((got == plain).mean()),
                margin_rule=margin_rule(f"spec session overlap {overlap}",
                                        [(ref, margins, got)], noise["tol"]))
            if leaked_pages(sess) or sess.pool.live_pages:
                raise AssertionError(f"spec session leaked pages at overlap {overlap}")
            del sess
        ids, lens = _overlap_drafts(plain, 1.0, vocab)
        sess = DecodeSession(gen, slots=8, capacity=cap, seed=seed, spec_k=SPEC_K)
        sess.admit(toks[:4], tags=[0, 1, 2, 3], drafts=(ids[:4], lens[:4]))
        sess.run_chunk(2)
        sess.admit(toks[4:8], tags=[4, 5, 6, 7], drafts=(ids[4:], lens[4:]))
        out = sorted(sess.drain(chunk=SPEC_K), key=lambda f: f["tag"])
        joined = margin_rule("spec session mid-flight join",
                             [(ref, margins, np.stack([f["tokens"] for f in out]))],
                             noise["tol"])
        joined_stats = sess.spec_stats
        leaked = leaked_pages(sess) + sess.pool.live_pages
    launches = launch_counts()     # ... and ends here
    if gen.device.type == "cuda" and launches["paged_decode_attention_block"] == 0:
        raise AssertionError(f"the spec session never launched the paged verify kernel: "
                             f"{launches}")
    if leaked:
        raise AssertionError(f"the mid-flight spec session leaked {leaked} pages")
    if not runs["1.0"]["spec_steps"] < max_new_tokens - 1:
        raise AssertionError(f"spec session at overlap 1.0: {runs['1.0']['spec_steps']} "
                             f"speculating verify blocks, not below the plain session's "
                             f"{max_new_tokens - 1} decode steps")
    return {"spec_k": SPEC_K, "chunk": SPEC_K, "overlap": runs, "mid_flight_join": joined,
            "mid_flight_spec_stats": joined_stats, "launches": launches, "leaked_pages": 0}


# ------------------------------------------------------------------ slice 3

def ivf_phase(eng, plan, serve_out, max_new_tokens: int):
    """The serve traffic through an engine whose bank has the IVF index
    (``CacheConfig(index="ivf")``: 2,048 clusters, bucket 256, nprobe 8 at
    262,144 rows), on the serve phase's weights and the serve phase's
    restored bank: one k-means rebuild, the member invariant, a full probe
    against the flat kernel, the 6 batches at the default nprobe (routes,
    recall@1 against the flat lookup, the shortlist kernel's launches), and
    the lookup time per batch of 8, flat and IVF, on the same bank.
    Returns (ivf line, the IVF engine)."""
    import dataclasses
    import torch
    from repro_torch.core import cache as cache_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core.engine import SharedCacheBank, TweakLLMEngine
    from repro_torch.core.router import RouterConfig
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.kernels import launch_counts, reset_launch_counts
    pairs, batches, n_fill, seed, threshold, _ = plan
    cfg = dataclasses.replace(eng.cache_cfg, index="ivf")
    p = index_lib.resolve(cfg)
    rcfg = RouterConfig(tweak_threshold=threshold)
    ieng = TweakLLMEngine(tokenizer=eng.tok, embedder_params=eng.embedder_params,
                          embedder_cfg=eng.embedder_cfg, big=eng.big, small=eng.small,
                          cache_cfg=cfg, router_cfg=rcfg)
    fill_bank(ieng, n_fill, seed)
    ieng.populate(*pairs)
    st = ieng.state
    _sync(eng.device)
    t0 = time.perf_counter()
    index_lib.build_index(st, cfg, seed=seed)
    _sync(eng.device)
    build_s = time.perf_counter() - t0
    per_slot = index_lib.live_entries_per_slot(st)
    bad = int((per_slot != st["valid"].long()).sum().item())
    if bad:
        raise AssertionError(f"ivf: {bad} slots do not have exactly one live member entry")
    valid = torch.nonzero(st["valid"])[:, 0]
    nearest = torch.cat([index_lib.nearest_clusters(st["ivf_centroids"], st["emb"][r])
                         for r in valid.split(8192)])
    spilled = int((nearest != st["ivf_assign"][valid]).sum().item())

    flat = dataclasses.replace(cfg, index="flat")
    full = dataclasses.replace(cfg, nprobe=p.nclusters)
    with torch.no_grad():
        q_all = [ieng.embed_texts([preprocess_query(x) for x in b]) for b in batches]
    worst, recall, held = 0.0, [], 0
    for q in q_all:
        fs, fi = cache_lib.lookup(st, flat, q)
        vs, vi = cache_lib.lookup(st, full, q)
        worst = max(worst, (vs - fs).abs().max().item())
        gap = torch.full_like(fs, float("inf"))
        d_ = torch.diff(fs, dim=1).abs()
        gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
        gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
        sure = gap > 1e-5
        if not torch.equal(vi[sure], fi[sure]):
            raise AssertionError("ivf: the full probe's indices differ from the flat kernel's")
        _, di = cache_lib.lookup(st, cfg, q)                     # the default nprobe
        probes = index_lib.probe_clusters(st["ivf_centroids"], q, p.nprobe)
        reach = (probes == st["ivf_assign"][fi[:, 0].long()][:, None]).any(1)
        same = di[:, 0] == fi[:, 0]
        reach &= sure[:, 0]                  # a tied flat top-1 may come back as its twin
        if not bool(same[reach].all()):
            raise AssertionError("ivf: a top-1 whose cluster was probed was missed")
        recall.append(same.float().mean().item())
        held += int(reach.sum().item())
    check("ivf full probe vs flat kernel", worst, 1e-5)

    reset_launch_counts()          # the IVF path starts here ...
    lat, res = _serve(ieng, batches, max_new_tokens)
    launches = launch_counts()     # ... and ends here
    n = len(batches) * len(batches[0])
    if eng.device.type == "cuda" and (launches["cosine_topk_gather"] < len(batches)
                                      or launches["cosine_topk"]):
        raise AssertionError(f"ivf: the lookups did not go through the shortlist kernel: "
                             f"{launches}")
    s = ieng.stats
    if s.total != n or s.suppressed_inserts != 0:
        raise AssertionError(f"ivf: EngineStats inconsistent: {s}")
    decisions = lambda rs: [[m["decision"] for m in r.meta] for r in rs]
    same_routes = sum(a == b for a, b in zip(decisions(res), decisions(serve_out)))

    lookup_ms = lookup_dev = None
    if eng.device.type == "cuda":
        flat_bank = SharedCacheBank(flat, rcfg, device=eng.device, state=st)
        banks = (("flat", flat_bank), ("ivf", ieng.bank))
        lookup_ms = {name: time_ms(lambda bank=bank: bank.route_batch(q_all[0]))
                     for name, bank in banks}
        # device time and kernel launches of one route_batch: what the host waits on
        lookup_dev = {}
        for name, bank in banks:
            ms, rows = device_ms(lambda bank=bank: bank.route_batch(q_all[0]), 5, split=True)
            lookup_dev[name] = {"device_ms": ms, "launches": sum(c for _, c in rows.values()),
                                "top": sorted(rows.items(), key=lambda r: -r[1][0])[:6]}
    return {"phase": "ivf", "bank_rows": cfg.capacity, "nclusters": p.nclusters,
            "bucket": p.bucket, "nprobe": p.nprobe, "candidates": p.nprobe * p.bucket,
            "build_index_s": build_s, "spilled_rows": spilled,
            "largest_cluster": int(st["ivf_count"].max().item()),
            "live_member_entries": int(per_slot.sum().item()), "valid_rows": int(valid.numel()),
            "full_probe_max_abs_err": worst, "recall_at_1": sum(recall) / len(recall),
            "rows_top1_reachable": held, "rows": n,
            "routes": {"exact": s.exact, "tweak": s.tweak, "miss": s.miss},
            "batches_with_serve_routes": same_routes, "batch_ms": lat,
            "steady_batch_ms_mean": sum(lat[1:]) / max(len(lat) - 1, 1),
            "lookup_ms_per_batch_of_8": lookup_ms, "lookup_device": lookup_dev,
            "launches": launches,
            "suppressed_inserts": s.suppressed_inserts}, ieng


# ------------------------------------------------------------------ slice 5

def replicas_phase(eng, plan, serve_out, dense_calls, spare, max_new_tokens: int, noise,
                   batch_s: float):
    """``ReplicaGroup.build(2, shared=True)`` over the serve phase's
    generators (shared handles, calls recorded) and restored bank, batch i
    to replica i % 2: routes equal the serve phase's, and every generate
    call's tokens equal the dense reference's (``paged_phase``'s re-run of
    the serve batches, margins recorded) under the margin rule; a MISS
    committed by one replica is an EXACT on the other.  Then a
    ``ReplicaScheduler`` on a ``SimClock`` replays the first ``REPLICA_TRACE``
    queries as a Poisson trace (each dispatch modelled at ``batch_s``, the serve phase's
    steady batch), once over a fresh shared bank and once over private
    banks: completions, per-lane dispatches and steals, hit rates (reported
    only).  Every replica leaks 0 KV pages."""
    import torch
    from repro_torch.core import router
    from repro_torch.core.engine import ReplicaGroup
    from repro_torch.core.router import RouterConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.scheduler import (ReplicaScheduler, SchedulerConfig, SimClock,
                                               poisson_trace, replay_trace)
    pairs, batches, n_fill, seed, threshold, _ = plan
    gens = {k: _gen_like(getattr(eng, k)) for k in ("big", "small")}
    calls = {k: record_calls(g) for k, g in gens.items()}

    def group(shared):
        g = ReplicaGroup.build(2, shared=shared, tokenizer=eng.tok,
                               embedder_params=eng.embedder_params,
                               embedder_cfg=eng.embedder_cfg, big=gens["big"],
                               small=gens["small"], cache_cfg=eng.cache_cfg,
                               router_cfg=RouterConfig(tweak_threshold=threshold))
        for e in g.engines[:1] if shared else g.engines:
            fill_bank(e, n_fill, seed)
            e.populate(*pairs)
        return g

    grp = group(True)
    _sync(eng.device)
    reset_launch_counts()          # the replica path starts here ...
    lat, res = [], []
    with torch.no_grad():
        for i, batch in enumerate(batches):
            t = time.perf_counter()
            res.append(grp[i % 2].handle_batch_result(batch, max_new_tokens=max_new_tokens))
            _sync(eng.device)
            lat.append((time.perf_counter() - t) * 1e3)
    launches = launch_counts()     # ... and ends here
    n = len(batches) * len(batches[0])
    _check_stats("replicas", grp.stats, n, max_new_tokens)
    if eng.device.type == "cuda" and min(launches[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"a kernel was not launched by the replica path: {launches}")
    decisions = lambda rs: [[m["decision"] for m in r.meta] for r in rs]
    if decisions(res) != decisions(serve_out):
        raise AssertionError("replicas: routes differ from the serve phase's on the same batches")
    if any(len(calls[k]) != len(dense_calls[k]) for k in calls):
        raise AssertionError("replicas: other generate calls than the single engine's")
    rule = {k: margin_rule(f"replicas {k}", [(r[0], r[1], p[0]) for r, p in
                                             zip(dense_calls[k], calls[k])],
                           noise[k]["tol"]) for k in calls}
    same = sum(a.responses == b.responses for a, b in zip(res, serve_out))
    per_replica = [e.stats.total for e in grp.engines]
    with torch.no_grad():
        _, meta = grp[0].handle_batch(spare, max_new_tokens=8, collect_meta=True)
        miss = [q for q, m in zip(spare, meta) if m["decision"] == router.MISS]
        if not miss:
            raise AssertionError("replicas: the spare batch has no MISS row to commit")
        _, other = grp[1].handle_batch(miss[:1], max_new_tokens=8, collect_meta=True)
    if other[0]["decision"] != router.EXACT:
        raise AssertionError(f"replicas: replica 0's MISS commit is not an EXACT hit on "
                             f"replica 1: {other[0]}")
    leaked = grp.leaked_kv_pages()
    del grp

    texts = [q for b in batches for q in b][:REPLICA_TRACE]
    trace = poisson_trace(texts, rate=12.0 / batch_s, seed=seed)
    sched_rows = {}
    for shared in (True, False):
        g = group(shared)
        sched = ReplicaScheduler(g.engines, SchedulerConfig(max_batch=8, max_wait=batch_s / 4,
                                                            max_new_tokens=max_new_tokens),
                                 clock=SimClock(), service_model=lambda b: batch_s)
        t = time.perf_counter()
        with torch.no_grad():
            done = replay_trace(sched, trace)
        wall = time.perf_counter() - t
        st = sched.stats
        if len(done) != len(texts) - st.rejected or st.completed != len(done):
            raise AssertionError(f"replica scheduler: {len(done)} completions of "
                                 f"{len(texts)} ({st.rejected} rejected)")
        leaked = [a + b for a, b in zip(leaked, g.leaked_kv_pages())]
        s = g.stats
        sched_rows["shared" if shared else "private"] = {
            "completed": st.completed, "rejected": st.rejected, "joined": st.joined,
            "batches": st.batches, "stolen": st.stolen, "sim_mean_latency_s": st.mean_latency,
            "lanes": [{"dispatched": ln.dispatched, "batches": ln.batches,
                       "stolen_in": ln.stolen_in} for ln in sched.lanes],
            "routes": {"exact": s.exact, "tweak": s.tweak, "miss": s.miss},
            "hit_rate": s.hit_rate, "wall_s": wall}
        del g, sched
    if any(leaked):
        raise AssertionError(f"replicas leaked KV pages: {leaked}")
    return {"phase": "replicas", "replicas": 2, "bank": "shared", "batch_ms": lat,
            "steady_batch_ms_mean": sum(lat[1:]) / max(len(lat) - 1, 1),
            "rows_per_replica": per_replica, "batches_with_serve_responses": same,
            "margin_rule": rule, "cross_replica_exact": True, "launches": launches,
            "scheduler": {"trace_queries": len(texts), "rate_per_s": 12.0 / batch_s,
                          "service_s": batch_s, **sched_rows},
            "leaked_kv_pages": leaked}


def sharded_phase(eng, ieng, plan, serve_out, max_new_tokens: int):
    """The serve phase's restored bank split into CACHE_SHARDS shards of
    65,536 rows, all on cuda:0 (``make_cache_mesh`` with the devices named),
    behind an engine on the serve phase's generators, against a local bank
    on the same weights and commits: per batch the merged top-k scores
    within 1e-5 of the local bank's and the same indices (away from ties),
    routes equal on rows away from the thresholds, ``cosine_topk`` launched
    once per shard per batch and one routing copy a batch; after the run
    the gathered state equals the local one bit for bit.  Then the ``ivf``
    phase's index, resharded, at a full probe gives the flat kernel's
    result, ``cosine_topk_gather`` once per shard.  ``route_batch`` ms,
    local against sharded, is reported only."""
    import dataclasses
    import torch
    from repro_torch.core import cache as cache_lib
    from repro_torch.core import distributed as dist
    from repro_torch.core import index as index_lib
    from repro_torch.core.engine import SharedCacheBank, TweakLLMEngine
    from repro_torch.core.router import RouterConfig
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_cache_mesh
    pairs, batches, n_fill, seed, threshold, _ = plan
    cfg = eng.cache_cfg
    devices = [eng.device] * CACHE_SHARDS
    mesh = make_cache_mesh(CACHE_SHARDS, devices=devices)
    leng = _engine_like(eng, eng.big, eng.small, threshold)
    fill_bank(leng, n_fill, seed)
    leng.populate(*pairs)
    sbank = SharedCacheBank(cfg, leng.router_cfg, mesh=mesh, state=leng.state)
    sbank.text_store.update(leng.bank.text_store)
    sbank.draft_store.update(leng.bank.draft_store)
    sbank.insert_seq = leng.bank.insert_seq
    seng = TweakLLMEngine(tokenizer=eng.tok, embedder_params=eng.embedder_params,
                          embedder_cfg=eng.embedder_cfg, big=eng.big, small=eng.small,
                          bank=sbank)
    routes = {"local": [], "sharded": []}
    for name, bank in (("local", leng.bank), ("sharded", sbank)):
        def wrapped(q, cost=None, inner=bank.route_batch, out=routes[name]):
            r = inner(q, cost)
            out.append((r[0].clone(), r[1].clone()))       # kept on the device
            return r
        bank.route_batch = wrapped
    _, lres = _serve(leng, batches, max_new_tokens)
    reset_launch_counts()          # the sharded path starts here ...
    lat, res, copies = [], [], []
    with torch.no_grad():
        for batch in batches:
            t = time.perf_counter()
            res.append(seng.handle_batch_result(batch, max_new_tokens=max_new_tokens))
            _sync(eng.device)
            lat.append((time.perf_counter() - t) * 1e3)
            copies.append(seng.last_route_syncs)
    launches = launch_counts()     # ... and ends here
    for bank in (leng.bank, sbank):
        del bank.route_batch
    n = len(batches) * len(batches[0])
    _check_stats("sharded", seng.stats, n, max_new_tokens)
    if eng.device.type == "cuda" and launches["cosine_topk"] != CACHE_SHARDS * len(batches):
        raise AssertionError(f"sharded: cosine_topk launched {launches['cosine_topk']} times, "
                             f"not {CACHE_SHARDS} a batch")
    if copies != [1] * len(batches):
        raise AssertionError(f"sharded: routing copies per batch {copies}, not 1")
    worst, near = 0.0, 0
    for (ls, li), (ss_, si) in zip(routes["local"], routes["sharded"]):
        worst = max(worst, (ss_ - ls).abs().max().item())
        gap = torch.full_like(ls, float("inf"))
        d_ = torch.diff(ls, dim=1).abs()
        gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
        gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
        sure = gap > 1e-5
        if not torch.equal(si[sure], li[sure]):
            raise AssertionError("sharded: merged indices differ from the local bank's")
    check("sharded top-k scores vs local bank", worst, 1e-5)
    exact = leng.router_cfg.exact_threshold
    for a, b in zip(res, lres):
        for ma, mb in zip(a.meta, b.meta):
            if min(abs(mb["sim"] - threshold), abs(mb["sim"] - exact)) < 5e-5:
                near += 1
            elif ma["decision"] != mb["decision"]:
                raise AssertionError(f"sharded: a route differs away from the thresholds: "
                                     f"{ma} vs {mb}")
    same_routes = [[m["decision"] for m in r.meta] for r in res] == [
        [m["decision"] for m in r.meta] for r in lres]
    gathered = dist.gather_cache_state(sbank.state, cfg)
    state_equal = {k: bool(torch.equal(gathered[k], v)) for k, v in leng.state.items()}
    if same_routes and not all(state_equal.values()):
        raise AssertionError(f"sharded: the gathered state differs from the local bank's: "
                             f"{state_equal}")
    responses_equal = sum(a.responses == b.responses for a, b in zip(res, lres))
    with torch.no_grad():
        q = seng.embed_texts([preprocess_query(x) for x in batches[0]])
    lookup_ms = None
    if eng.device.type == "cuda":
        lookup_ms = {"local": time_ms(lambda: leng.bank.route_batch(q)),
                     "sharded": time_ms(lambda: sbank.route_batch(q))}
    del leng, seng, sbank, gathered

    # the ivf phase's index, resharded, at a full probe
    icfg = ieng.cache_cfg
    p = index_lib.resolve(icfg)
    full = dataclasses.replace(icfg, nprobe=p.nclusters)
    ist = ieng.state
    rebuilt = bool(ist["ivf_overflow"])
    if rebuilt:
        index_lib.build_index(ist, icfg, seed=seed)
    sivf = dist.shard_ivf_cache_state(ist, mesh, full)
    with torch.no_grad():
        qi = ieng.embed_texts([preprocess_query(x) for x in batches[0]])
        reset_launch_counts()      # one sharded IVF lookup starts here ...
        vs, vi = dist.lookup(sivf, full, qi)
        gl = launch_counts()       # ... and ends here
        fs, fi = cache_lib.lookup(ist, dataclasses.replace(icfg, index="flat"), qi)
    if eng.device.type == "cuda" and (gl["cosine_topk_gather"] != CACHE_SHARDS
                                      or gl["cosine_topk"]):
        raise AssertionError(f"sharded ivf: launches {gl}, not the shortlist kernel once "
                             f"per shard")
    ivf_err = (vs - fs).abs().max().item()
    check("sharded ivf full probe vs flat kernel", ivf_err, 1e-5)
    gap = torch.full_like(fs, float("inf"))
    d_ = torch.diff(fs, dim=1).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
    if not torch.equal(vi[gap > 1e-5], fi[gap > 1e-5]):
        raise AssertionError("sharded ivf: full-probe indices differ from the flat kernel's")
    sharded_ivf_ms = (time_ms(lambda: dist.lookup(sivf, full, qi), reps=5)
                      if eng.device.type == "cuda" else None)
    return {"phase": "sharded", "shards": CACHE_SHARDS,
            "devices": [str(d) for d in devices], "rows_per_shard": cfg.capacity // CACHE_SHARDS,
            "topk_max_abs_err": worst, "rows_near_threshold": near,
            "routes_equal": same_routes, "state_equal": all(state_equal.values()),
            "batches_with_local_responses": responses_equal, "route_copies": copies,
            "batch_ms": lat, "steady_batch_ms_mean": sum(lat[1:]) / max(len(lat) - 1, 1),
            "route_batch_ms": lookup_ms, "launches": launches,
            "ivf": {"nclusters": p.nclusters, "nprobe": p.nclusters, "rebuilt_first": rebuilt,
                    "full_probe_max_abs_err": ivf_err, "launches": gl,
                    "lookup_ms": sharded_ivf_ms}}


# ------------------------------------------------------------------ slice 4

def cascade_band(serve_out, threshold: float, exact: float, rows: int = 8):
    """The narrowest band (``RouterConfig.band``) around ``threshold`` that
    holds at least ``rows`` of the serve phase's non-EXACT top-1s, plus 1e-4
    so none sits on its edge."""
    dist = sorted(abs(m["sim"] - threshold) for r in serve_out for m in r.meta
                  if m["sim"] < exact)
    if len(dist) < rows:
        raise AssertionError(f"cascade: only {len(dist)} non-EXACT rows to put in a band")
    return 2 * dist[rows - 1] + 1e-4


def cascade_phase(eng, plan, serve_out, reranker, max_new_tokens: int):
    """The serve traffic through an engine with the router cascade on (a band
    around the serve threshold that holds >= 8 of the 48 rows, the trained
    reranker), on the serve phase's weights and restored bank.  Checks: rows
    outside the band route as in the serve phase; stage 2 re-run on CPU
    copies of its inputs gives the same decisions and slots, conf within 1e-4
    (rows within 1e-3 of the commit threshold excepted and counted); one
    routing copy per batch, two on a batch with UNCERTAIN rows; one
    ``cosine_topk`` per batch.  Reports the stage-2 resolve's time."""
    import torch
    from repro_torch.core import router as router_lib
    from repro_torch.core.cache import make_second_stage
    from repro_torch.core.engine import TweakLLMEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import tree_map
    pairs, batches, n_fill, seed, threshold, _ = plan
    exact = router_lib.RouterConfig().exact_threshold
    band = cascade_band(serve_out, threshold, exact)
    rcfg = router_lib.RouterConfig(tweak_threshold=threshold, band=band)
    ceng = TweakLLMEngine(tokenizer=eng.tok, embedder_params=eng.embedder_params,
                          embedder_cfg=eng.embedder_cfg, big=eng.big, small=eng.small,
                          cache_cfg=eng.cache_cfg, router_cfg=rcfg, reranker=reranker)
    fill_bank(ceng, n_fill, seed)
    ceng.populate(*pairs)
    calls = []
    resolve = ceng.bank.second_stage

    def recording(*args):            # the inputs are small; kept on the device
        out = resolve(*args)
        calls.append(([a.clone() for a in args], [o.clone() for o in out]))
        return out

    ceng.bank.second_stage = recording
    _sync(eng.device)
    reset_launch_counts()          # the cascade path starts here ...
    lat, res, syncs = [], [], []
    with torch.no_grad():
        for batch in batches:
            t = time.perf_counter()
            r = ceng.handle_batch_result(batch, max_new_tokens=max_new_tokens)
            _sync(eng.device)
            lat.append((time.perf_counter() - t) * 1e3)
            res.append(r)
            syncs.append((ceng.last_route_syncs, any(m["stage2"] for m in r.meta)))
    launches = launch_counts()     # ... and ends here
    ceng.bank.second_stage = resolve
    s = ceng.stats
    in_band = sum(abs(m["sim"] - threshold) < band / 2 and m["sim"] < exact
                  for r in serve_out for m in r.meta)
    if s.total != len(batches) * len(batches[0]) or in_band < 8 or s.uncertain == 0:
        raise AssertionError(f"cascade: {in_band} serve rows in the band {band}, "
                             f"{s.uncertain} uncertain: {s}")
    if any(n != 1 + s2 for n, s2 in syncs):
        raise AssertionError(f"cascade: routing copies per batch (copies, stage 2): {syncs}")
    if eng.device.type == "cuda" and launches["cosine_topk"] != len(batches):
        raise AssertionError(f"cascade: cosine_topk launches {launches['cosine_topk']} for "
                             f"{len(batches)} batches")
    lo, hi = threshold - band / 2, threshold + band / 2
    outside = same = diverged = 0
    for rc, rs in zip(res, serve_out):
        for mc, ms in zip(rc.meta, rs.meta):
            if abs(mc["sim"] - ms["sim"]) > 1e-5:       # an earlier stage-2 route moved the bank
                diverged += 1
            elif min(abs(ms["sim"] - lo), abs(ms["sim"] - hi)) > 1e-4 and not lo < ms["sim"] < hi:
                outside += 1
                same += mc["decision"] == ms["decision"]
    if same != outside:
        raise AssertionError(f"cascade: {outside - same} rows outside the band routed "
                             "otherwise than in the serve phase")
    # stage 2 on the CPU, on copies of its inputs
    cpu = lambda t: t.detach().cpu()
    st = ceng.state
    cpu_state = {"q_tokens": cpu(st["q_tokens"]), "q_mask": cpu(st["q_mask"]),
                 "last_used": torch.zeros(st["last_used"].shape, dtype=torch.int32),
                 "hits": torch.zeros(st["hits"].shape, dtype=torch.int32),
                 "clock": torch.zeros((), dtype=torch.int32)}
    rr_params, rr_cfg = reranker
    cpu_stage = make_second_stage(eng.cache_cfg, rcfg, tree_map(cpu, rr_params), rr_cfg)
    commit_conf = rcfg.commit_at * (rcfg.w_agree + rcfg.w_rerank)
    worst, excepted = 0.0, 0
    for args, (final, slot, conf) in calls:
        _, f_c, s_c, c_c = cpu_stage(cpu_state, *[cpu(a) for a in args])
        near = (cpu(conf) - commit_conf).abs() < 1e-3
        excepted += int(near.sum())
        keep = ~near
        if not (torch.equal(f_c[keep], cpu(final)[keep]) and torch.equal(s_c[keep],
                                                                          cpu(slot)[keep])):
            raise AssertionError("cascade: stage 2 on the CPU decided otherwise than the card")
        if keep.any():
            worst = max(worst, float((c_c - cpu(conf))[keep].abs().max()))
    check("cascade stage-2 conf, card vs CPU", worst, 1e-4)
    stage2_ms = stage2_dev = None
    if eng.device.type == "cuda" and calls:
        args = calls[-1][0]
        stage2_ms = time_ms(lambda: ceng.bank.second_stage(*args))
        # one call profiled: ~300 kernels, the whole-multiple check of
        # device_ms has nothing to catch at reps 1 (a lost record of a
        # µs-scale kernel would move the ms-scale sum by ~1e-3 of it)
        stage2_dev = device_ms(lambda: ceng.bank.second_stage(*args), 1)
    return {"phase": "cascade", "band": band, "tau": threshold, "commit_conf": commit_conf,
            "reranker": rr_cfg.name, "serve_rows_in_band": in_band,
            "uncertain": s.uncertain, "recovered": s.recovered,
            "routes": {"exact": s.exact, "tweak": s.tweak, "miss": s.miss},
            "stage2_batches": sum(s2 for _, s2 in syncs), "routing_copies": [n for n, _ in syncs],
            "rows_outside_band": outside, "rows_bank_diverged": diverged,
            "stage2_conf_max_abs_err_cpu": worst, "stage2_rows_near_commit": excepted,
            "stage2_resolve_ms": stage2_ms, "stage2_resolve_device_ms": stage2_dev,
            "batch_ms": lat, "launches": launches}


def baseline_phase(eng, plan, reranker, seed: int):
    """The GPTCache baseline on a bank of the serve phase's size: the populated
    pairs put in one at a time, then ``get`` over a held-out duplicate (the
    same topic and intent, rendered anew) and a hard negative (the same
    topic, another intent) of each; precision and recall of its hits.  It
    only reports."""
    import numpy as np
    import torch
    from repro_torch.core.baseline import BaselineConfig, GPTCacheBaseline
    from repro_torch.data.questions import _INTENTS, _render
    from repro_torch.eval.metrics import pr_curve, precision_recall
    pairs, _, _, _, _, pop = plan
    rr_params, rr_cfg = reranker
    cfg = BaselineConfig()
    base = GPTCacheBaseline(tokenizer=eng.tok, embedder_params=eng.embedder_params,
                            embedder_cfg=eng.embedder_cfg, reranker_params=rr_params,
                            reranker_cfg=rr_cfg, cache_cfg=eng.cache_cfg, cfg=cfg)
    rng = np.random.default_rng(seed + 2000)
    queries, labels, source = [], [], []
    for q in pop:
        other = [i for i in _INTENTS if i != q.intent]
        queries += [_render(rng, q.topic, q.intent),
                    _render(rng, q.topic, other[int(rng.integers(len(other)))])]
        labels += [True, False]
        source += [q.text, None]
    with torch.no_grad():
        _sync(eng.device)
        t = time.perf_counter()
        for query, response in zip(*pairs):
            base.put(query, response)
        _sync(eng.device)
        put_ms = (time.perf_counter() - t) * 1e3 / len(pairs[0])
        t = time.perf_counter()
        got = [base.get(x) for x in queries]
        get_ms = (time.perf_counter() - t) * 1e3 / len(queries)
    hits = np.asarray([cq is not None for cq, _, _ in got])
    labels = np.asarray(labels)
    precision, recall = precision_recall(hits, labels)
    scores = np.asarray([sc for _, _, sc in got])
    to_source = sum(cq == src for (cq, _, _), src in zip(got, source) if src and cq)
    return {"phase": "baseline", "bank_rows": eng.cache_cfg.capacity, "entries": len(pairs[0]),
            "threshold": cfg.similarity_threshold, "rerank": cfg.rerank,
            "queries": len(queries), "duplicates": int(labels.sum()), "hits": int(hits.sum()),
            "precision": precision, "recall": recall,
            "duplicate_hits_on_their_source": to_source,
            "pr_curve_top1": pr_curve(scores, labels, np.linspace(0.5, 0.95, 10)),
            "put_ms_mean": put_ms, "get_ms_mean": get_ms}


# ------------------------------------------------------------------ the analyzer

def _screened_batch(eng, pop, tweaks, rng, seed: int, n_exact: int = 2, n_tweak: int = 3,
                    n_miss: int = 3):
    """A batch of the plan's traffic whose routes are known before it runs:
    populated queries ``pop`` (EXACT), served TWEAK edits that still route TWEAK,
    and fresh queries whose best similarity sits well below the threshold
    (MISS), each checked by a read-only flat lookup of the bank."""
    import torch
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.data import QuestionPairGenerator
    thr, exact = eng.router_cfg.tweak_threshold, eng.router_cfg.exact_threshold
    g = QuestionPairGenerator(seed=seed)
    fresh = [g._random_query().text for _ in range(64)]
    with torch.no_grad():
        top = lambda qs: cache_lib.lookup(eng.state, eng.cache_cfg, eng.embed_texts(
            [preprocess_query(q) for q in qs]))[0][:, 0].cpu().tolist()
        tw = [q for q, sc in zip(tweaks, top(tweaks)) if thr + 0.005 < sc < exact]
        ms = [q for q, sc in zip(fresh, top(fresh)) if sc < thr - 0.01]
    if len(tw) < n_tweak or len(ms) < n_miss:
        raise AssertionError(f"analysis: {len(tw)} TWEAK and {len(ms)} MISS candidates")
    rows = ([pop[int(i)] for i in rng.choice(len(pop), n_exact, replace=False)]
            + [tw[int(i)] for i in rng.choice(len(tw), n_tweak, replace=False)]
            + ms[:n_miss])
    return [rows[int(i)] for i in rng.permutation(len(rows))]


def analysis_phase(eng, plan, served, max_new_tokens: int, seed: int):
    """The analyzer on the card: ``contracts.run_all(device="cuda")`` (every
    registered hot path at the reference's tiny buckets, twice), then one
    more batch of the plan's traffic (8 queries, 2 EXACT, 3 TWEAK, 3 MISS)
    through the serve engine under ``contracts.counting`` (the
    TorchFunctionMode counter and ``set_sync_debug_mode("warn")``), and one
    plain and one speculative ``Generator`` call the same way.  Fails on a
    count over its budget, a disagreement of the two counts or a bank leaf
    reallocated.  The serve batch's wall time is read without the modes on a
    second batch of the same make-up."""
    import numpy as np
    import torch
    from repro_torch.analysis import contracts
    from repro_torch.core import tweak as tweak_lib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batcher import bucket_len, pad_to_buckets
    dev = eng.device
    t0 = time.perf_counter()
    failures = contracts.run_all(device=dev.type)
    if failures:
        raise AssertionError("analysis: contract failures:\n" + "\n".join(failures))
    contracts_s = time.perf_counter() - t0
    tweaks = sorted({q for batch, res in zip(plan[1], served) for q, m in zip(batch, res.meta)
                     if m["decision"] == 1})
    rng = np.random.default_rng(seed + 40)
    pop = plan[0][0]               # the populated queries as the plan wrote them
    batch = _screened_batch(eng, pop, tweaks, rng, seed + 40)
    spare = _screened_batch(eng, pop, [q for q in tweaks if q not in batch], rng, seed + 41)
    before = contracts.storage_of(eng.state)
    reset_launch_counts()          # the analysed serve batch starts here ...
    with torch.no_grad():
        _sync(dev)
        t = time.perf_counter()
        with contracts.counting(dev) as c:
            res, calls = contracts.engine_budget(
                eng, lambda: eng.handle_batch_result(batch, max_new_tokens=max_new_tokens))
        _sync(dev)
        counted_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()     # ... and ends here
    failures = contracts.check_engine_batch("analysis serve batch", eng, c, calls)
    failures += contracts.check_in_place("analysis serve batch", "bank state", before,
                                         eng.state)
    routes = [m["decision"] for m in res.meta]
    if not (routes.count(1) and routes.count(0)):
        failures.append(f"analysis: the batch lacks a TWEAK or a MISS row: {routes}")
    if dev.type == "cuda" and min(launches[k] for k in SERVE_KERNELS) == 0:
        failures.append(f"analysis: a kernel of the serve path did not launch: {launches}")
    with torch.no_grad():
        _sync(dev)
        t = time.perf_counter()
        plain_res = eng.handle_batch_result(spare, max_new_tokens=max_new_tokens)
        _sync(dev)
        plain_ms = (time.perf_counter() - t) * 1e3
    serve = {"routes_miss_tweak_exact_uncertain": [routes.count(d) for d in range(3)]
             + [sum(m["stage2"] for m in res.meta)],
             "budget": eng.last_route_syncs + calls["generate"] + calls["insert"],
             "last_route_syncs": eng.last_route_syncs, "generator_calls": calls["generate"],
             "inserts": calls["insert"], **c.report(), "wall_ms_counted": counted_ms,
             "wall_ms_plain": plain_ms,
             "plain_batch_routes": [m["decision"] for m in plain_res.meta]}

    # one plain and one speculative Generator call: a TWEAK batch over the prefix
    small = eng.small
    pick = list(eng.bank.text_store.items())[:8]
    st, sm = tweak_lib.build_tweak_suffix_batch(
        eng.tok, [q + " please" for _, (q, _) in pick], [q for _, (q, _) in pick],
        [r for _, (_, r) in pick], 1024)
    width = bucket_len(int(sm.sum(1).max()))
    st = pad_to_buckets(st[:, :width], sm[:, :width])[0]
    pc = small.build_prefix_cache(tweak_lib.tweak_prefix_ids(eng.tok), st.shape[0])
    spec = _gen_like(small, spec_k=SPEC_K)
    gens = {}
    with torch.no_grad():
        for name, gen, drafts in (("plain", small, None), ("spec", spec, "own")):
            if drafts == "own":
                drafts = _overlap_drafts(gens["plain"]["tokens"], 1.0,
                                         small.model.cfg.vocab_size)
            with contracts.counting(dev) as gc:
                toks = gen.generate_with_lengths({"tokens": st}, max_new_tokens=max_new_tokens,
                                                 seed=seed, prefix_cache=pc, drafts=drafts)[0]
            budget = 1 if drafts is None else 2 + gen.last_spec_stats["spec_steps"]
            failures += contracts.check_counter(f"analysis {name} generate", gc, budget)
            if gc.total != budget or (drafts is not None and gc.total != gen.last_spec_syncs):
                failures.append(f"analysis {name} generate: {gc.total} syncs, want {budget}")
            gens[name] = {"budget": budget, **gc.report(), "tokens": toks}
    if not np.array_equal(gens["plain"]["tokens"], gens["spec"]["tokens"]):
        failures.append("analysis: the speculative call's tokens differ from the plain call's")
    for g in gens.values():
        g.pop("tokens")
    gens["spec"]["last_spec_syncs"] = spec.last_spec_syncs
    gens["spec"]["spec_steps"] = spec.last_spec_stats["spec_steps"]
    if failures:
        raise AssertionError("analysis:\n" + "\n".join(failures))
    return {"phase": "analysis", "seconds": time.perf_counter() - t0,
            "contracts": {"paths": len(contracts.CONTRACTS), "failures": 0,
                          "seconds": contracts_s},
            "serve_batch": serve, "generate": gens,
            "launches": {k: v for k, v in launches.items() if v}}


def spare_tokens(eng, batch):
    """A planned batch as the big model's padded prompt tokens (B, 16)."""
    from repro_torch.core.tweak import preprocess_query
    from repro_torch.serving.batcher import pad_to_buckets
    toks, mask = eng.tok.encode_batch([preprocess_query(q) for q in batch], eng.max_query_len)
    return pad_to_buckets(toks, mask)[0]


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


def paged_decode_profile(eng, batch, max_new_tokens: int, seed: int):
    """One paged decode of ``batch`` on the big model (a paged generator on
    its weights, warmed once) under ``torch.profiler``: wall and device-busy
    ms, and the paged attention kernels' device ms and launches in it."""
    import torch
    gen = _gen_like(eng.big, paged=True, page_size=PAGE, pool_pages=POOL_PAGES)
    toks = {"tokens": spare_tokens(eng, batch)}
    run = lambda: gen.generate_with_lengths(toks, max_new_tokens=max_new_tokens, seed=seed)
    run()
    _sync(eng.device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(eng.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    paged = [r for r in rows if "PagedKV" in r[0]]
    return {"wall_ms": wall_ms, "device_busy_ms": sum(r[1] for r in rows) / 1e3,
            "kernel_launches": sum(r[2] for r in rows),
            "paged_attention_device_ms": sum(r[1] for r in paged) / 1e3,
            "paged_attention_launches": sum(r[2] for r in paged)}


def profile_phase(eng, batch, max_new_tokens: int, seed: int):
    """Where the time goes, on the engine the serve phase left: one decode
    step alone, then one more serve batch under ``torch.profiler``, then one
    paged decode of the same batch (``paged_decode``)."""
    import torch
    seconds = {}
    t = time.perf_counter()
    with torch.no_grad():
        step = decode_step_timing(eng, seed)
        seconds["decode_step"] = time.perf_counter() - t
        # the device's activity alone: the rows read only kernels, and host-op
        # records of ~121,000 launches took most of the phase
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, meta = eng.handle_batch(batch, max_new_tokens=max_new_tokens,
                                       collect_meta=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        seconds["serve_batch"] = time.perf_counter() - t0
        t = time.perf_counter()
        rows = kernel_rows(prof)
        seconds["serve_batch_rows"] = time.perf_counter() - t
        t = time.perf_counter()
        paged = paged_decode_profile(eng, batch, max_new_tokens, seed)
        seconds["paged_decode"] = time.perf_counter() - t
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiled serve batch recorded no device time")
    routes = {d: sum(m["decision"] == d for m in meta) for d in (0, 1, 2)}
    return {"phase": "profile", "decode_step": step, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "routes_miss_tweak_exact": [routes[0], routes[1], routes[2]],
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for k, us, c in rows[:15]], "paged_decode": paged,
            "seconds_by_part": seconds}


SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:64"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:142"),
    "cosine_topk": ("src/repro_torch/csrc/cosine_topk.cu",
                    "src/repro/kernels/cosine_topk/kernel.py:143"),
    "decode_attention_block": ("src/repro_torch/csrc/decode_attention_block.cu",
                               "src/repro/kernels/decode_attention/kernel.py:98"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention/kernel.py:151"),
    "paged_decode_attention_block": ("src/repro_torch/csrc/paged_attention.cu",
                                     "src/repro/kernels/paged_attention/kernel.py:103"),
    "cosine_topk_gather": ("src/repro_torch/csrc/cosine_topk_gather.cu",
                           "src/repro/kernels/cosine_topk/kernel.py:103"),
}
SUMMARY_CASE = {"flash_attention": "small-suffix-over-prefix",
                "decode_attention": "small-tweak-decode", "cosine_topk": "serve-bank",
                "decode_attention_block": "small-tweak-verify-k4",
                "paged_decode_attention": "small-tweak-paged-decode",
                "paged_decode_attention_block": "small-tweak-paged-verify-k4",
                "cosine_topk_gather": "ivf-probe"}
SERVE_KERNELS = ("flash_attention", "decode_attention", "cosine_topk")
# a call of each of these is one kernel launch: bf16 calls of the four
# attention kernels run panel_mma_kernel alone, the splits merged in their
# cluster; the shortlist kernel merges a query's blocks in theirs
ONE_LAUNCH_KERNELS = ("decode_attention", "decode_attention_block", "paged_decode_attention",
                      "paged_decode_attention_block", "cosine_topk_gather")
# the CUDA-core attention bodies, built for fp32 only
SIMT_FP32_ONLY = ("decode_split_kernel", "decode_merge_kernel", "panel_split_kernel",
                  "panel_merge_kernel")
# the phase whose run each kernel's launches are read from
LAUNCH_PHASE = {"flash_attention": "serve", "decode_attention": "serve",
                "cosine_topk": "serve", "decode_attention_block": "spec",
                "paged_decode_attention": "paged", "paged_decode_attention_block": "spec",
                "cosine_topk_gather": "ivf"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    # the shapes phase plans a step to fill the card beside the tensors the
    # kernel cases hold until they are profiled; a fixed-segment cache can
    # leave GBs of freed blocks too small for its 9 GB logits
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    sass = {k: v for k, v in build.sass_opcodes().items() if any(v.values())}
    waves = wave_clusters(build)
    waves["gather"] = gather_wave_clusters(build)
    resources = build.kernel_resources()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build.build_seconds,
          "device_count": torch.cuda.device_count(),
          "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
          "kernel_resources": resources, "sass_opcodes": sass, "wave_clusters": waves})
    for kernel in ("flash_fwd_mma_kernel", "panel_mma_kernel"):   # flash; attention panels
        mma = [v for k, v in sass.items() if k.startswith(kernel)]
        if sass and not (mma and all(v["HMMA"] and v["LDGSTS"] for v in mma)):
            raise AssertionError(f"{kernel}: an instance lacks HMMA or LDGSTS: {mma}")
    for kv in ("DenseKV", "PagedKV"):   # dense decode and verify; paged decode and verify
        if sass and not any(k.startswith("panel_mma_kernel") and kv in k for k in sass):
            raise AssertionError(f"panel_mma_kernel: no {kv} instance was built")
    spilled = {k: v["spill_bytes"] for k, v in resources.items()
               if k.startswith(("panel_mma_kernel", "gather_topk_kernel",
                                "flash_fwd_mma_kernel<256>")) and v["spill_bytes"]}
    if spilled:
        raise AssertionError(f"kernel instances that spill: {spilled}")
    simt_bf16 = [k for k in resources if k.split("<")[0] in SIMT_FP32_ONLY and "bfloat16" in k]
    if simt_bf16:
        raise AssertionError(f"bf16 instances of the CUDA-core attention bodies: {simt_bf16}")

    prefix_len = len(tweak_lib.tweak_prefix_ids(HashWordTokenizer(128256)))
    checked = kernel_phase(prefix_len, args.seed)
    mark("kernel_cases")
    serve_cli = serve_cli_phase()
    emit(serve_cli)
    train, reranker = train_phase("llama-3.1-8b", torch.device("cuda"), args.seed)
    emit(train)
    sets = judge_sets(args.seed, JUDGE_PAIRS)
    lm_train, lm, lm_params, lm_tok, before = lm_train_phase(torch.device("cuda"), args.seed,
                                                             sets)
    emit(lm_train)
    zero_train = zero_train_phase(torch.device("cuda"), args.seed)
    emit(zero_train)
    judge = judge_phase(lm, lm_params, lm_tok, sets, before, torch.device("cuda"), args.seed)
    emit(judge)
    del lm_params, before
    torch.cuda.empty_cache()
    archs = archs_phase(args.seed)
    emit(archs)
    smoke_paths = smoke_paths_phase(args.seed)
    emit(smoke_paths)
    examples = examples_phase()
    emit(examples)
    shapes = shapes_phase(args.seed)
    emit(shapes)
    checked += shape_kernel_cases(torch.Generator(device="cuda").manual_seed(args.seed))
    mark("shape_kernel_cases")
    serve, launches, eng, spare, plan, served = serve_phase(
        "llama-3.1-8b", torch.device("cuda"), args.seed, N_BATCHES, MAX_NEW_TOKENS)
    emit(serve)
    with torch.no_grad():
        probe = torch.as_tensor(spare_tokens(eng, spare), device=eng.device).long()
        noise = {k: path_noise(getattr(eng, k).model, getattr(eng, k).params,
                               getattr(eng, k).cfg.sampler, probe) for k in ("big", "small")}
    paged, peng, dense_calls = paged_phase(eng, plan, served, MAX_NEW_TOKENS, noise)
    emit(paged)
    spec = spec_phase(eng, peng, plan[1][0], MAX_NEW_TOKENS, noise["small"])
    emit(spec)
    del peng
    session = session_phase(eng, spare + plan[1][1], MAX_NEW_TOKENS, args.seed, noise["big"])
    emit(session)
    ivf, ieng = ivf_phase(eng, plan, served, MAX_NEW_TOKENS)
    emit(ivf)
    replicas = replicas_phase(eng, plan, served, dense_calls, spare, MAX_NEW_TOKENS, noise,
                              serve["steady_batch_ms_mean"] / 1e3)
    emit(replicas)
    del dense_calls
    sharded = sharded_phase(eng, ieng, plan, served, MAX_NEW_TOKENS)
    emit(sharded)
    del ieng
    emit(cascade_phase(eng, plan, served, reranker, MAX_NEW_TOKENS))
    emit(baseline_phase(eng, plan, reranker, args.seed))
    analysis = analysis_phase(eng, plan, served, MAX_NEW_TOKENS, args.seed)
    emit(analysis)
    phase_launches = {"serve": launches, "paged": paged["launches"], "spec": spec["launches"],
                      "ivf": ivf["launches"]}
    # the profiler only after serving: the serve timings stay free of
    # whatever it leaves attached to the process
    cases = []
    for row, (run, library, reps) in checked:
        row["device_ms"], row["device_by_kernel"] = device_ms(run, reps, split=True)
        per_call = [n for _, n in row["device_by_kernel"].values()]
        one = row["name"] in ONE_LAUNCH_KERNELS and row["shape"].get("route") != "panel"
        if one and per_call != [1.0]:
            raise AssertionError(f"{row['name']}[{row['case']}]: launches per call "
                                 f"{row['device_by_kernel']}, not one kernel once")
        row["library_device_ms"] = device_ms(library, reps)
        cases.append(row)
        emit(row)
    emit(dict(profile_phase(eng, spare, MAX_NEW_TOKENS, args.seed), nvidia_smi=smi))
    worst = {}
    for c in cases:
        worst[c["name"]] = max(worst.get(c["name"], 0.0), c["max_abs_err"])
    summary = []
    for name, (source, replaces) in SOURCES.items():
        c = next(x for x in cases if x["name"] == name and x["case"] == SUMMARY_CASE[name])
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": phase_launches[LAUNCH_PHASE[name]][name],
                        "launch_phase": LAUNCH_PHASE[name], "max_abs_err": worst[name],
                        "ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"]})
    summary[0].update(launches_lm_train=lm_train["flash_launches"],
                      launches_judge=judge["flash_launches"],
                      launches_archs=archs["launches"]["flash_attention"])
    summary[0]["launches_shapes"] = shapes["launches"]["flash_attention"]
    summary[0]["launches_zero_train"] = zero_train["flash_launches"]
    for row in summary[:3]:    # the analysed serve batch: flash, dense decode, flat scan
        row["launches_analysis"] = analysis["launches"].get(row["name"], 0)
    summary[1].update(launches_archs=archs["launches"]["decode_attention"],
                      launches_serve_cli=serve_cli["kernel_launches"]["decode_attention"],
                      launches_shapes=shapes["launches"]["decode_attention"])
    for row in summary[3:6]:   # the verify and paged kernels: qwen3-moe's paths at G 16
        row["launches_archs"] = archs["launches"][row["name"]]
    for row in summary[:2] + summary[3:6]:   # the smoke configs' paths, fp32 at dh 16-32
        row["launches_smoke_paths"] = smoke_paths["launches"][row["name"]]
    for row in summary[:3]:    # the examples' serving runs: flash, dense decode, flat scan
        row["launches_examples"] = sum(e["kernel_launches"].get(row["name"], 0)
                                       for e in examples["examples"].values())
    for row in summary:    # every case of the kernel, the summary's own included
        row["cases"] = [{k: c.get(k) for k in ("case", "max_abs_err", "ms", "device_ms",
                                                "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "library_device_ms")}
                        for c in cases if c["name"] == row["name"]]
    emit({"phase": "wall", "script_s": time.perf_counter() - t_start, "phase_s": PHASE_S,
          "kernel_build_s": build.build_seconds, "profiler_sessions": profiler_sessions})
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
