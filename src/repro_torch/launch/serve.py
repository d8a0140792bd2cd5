"""Build a TweakLLM serving stack on one device (counterpart of
``src/repro/launch/serve.py::build_stack/build_engine``).

Two stacks:

* ``"serve-tiny"`` — the reference's 4L/2L pair (big 4L d128 8H/4kv naive
  attention; small 2L d64 4H/2kv ``xla_flash`` with 32-token blocks), the
  tiny embedder and the tiny reranker, vocab 8192 by default; the CPU tests
  use it.
* ``"llama-3.1-8b"`` — the paper's Small LLM at full width for both roles:
  big = ``configs.llama31_8b.CONFIG`` (it stands in for the frontier Big LLM,
  which no single H100 holds); small = the same config with fixed 64-token
  ``xla_flash`` blocks, so the TWEAK path reuses the instruction-prefix KV;
  embedder = MiniLM at full width (6L d384 12H) over the LM's 128,256-token
  vocabulary; the reranker at the same width (the shape of the public
  MiniLM-L6 duplicate-question cross-encoders); a FIFO bank of 262,144 rows.

The bank's index is flat by default; ``index="ivf"`` clusters it
(``core/index.py``: 2,048 clusters of 256 member slots, 8 probed, at the
llama bank size), and ``admit_floor > 0`` turns on per-cluster admission.
As in the reference, the embedder is trained contrastively
(``train_embedder_steps``, 60 by default), and ``band > 0`` turns on the
router cascade: the stack then also builds and trains the cross-encoder
reranker (``train_reranker_steps``, 120) and returns it under ``reranker``.
Weights start random, drawn on the device from ``torch.Generator``s seeded
from ``seed`` (the repo has no public weights).  ``build_replica_group``
puts N engine replicas over one shared bank (or private ones), row-sharded
over a cache mesh when ``cache_shards > 1``.

``main`` is the serving CLI of ``src/repro/launch/serve.py``: it replays a
Zipfian arrival trace through the scheduler and prints the same report.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 200 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --index ivf --admit-floor 0.2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --band 0.12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 --cache-shards 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --model llama-3.1-8b   # on the card
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import llama31_8b
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import ReplicaGroup, TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import WorkloadGenerator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.embedder import MINILM_CONFIG, init_embedder, tiny_embedder_config
from repro_torch.models.reranker import init_reranker, tiny_reranker_config
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import (ReplicaScheduler, Scheduler, SchedulerConfig,
                                           SimClock, poisson_trace, replay_trace)
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training.embedder_train import train_embedder
from repro_torch.training.reranker_train import train_reranker

MODELS = ("serve-tiny", "llama-3.1-8b")
LLAMA_FLASH_BLOCK = 64
LLAMA_CAPACITY = 262_144


def model_configs(model: str, vocab: int = 8192):
    """(big, small, embedder, reranker) configs of a named stack."""
    if model == "serve-tiny":
        big = ModelConfig(name="big", num_layers=4, d_model=128, num_heads=8,
                          num_kv_heads=4, d_ff=256, vocab_size=vocab,
                          max_seq_len=1024, dtype="float32")
        small = big.replace(name="small", num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, d_ff=128, attention_impl="xla_flash",
                            flash_block_q=32, flash_block_k=32)
        return big, small, tiny_embedder_config(vocab), tiny_reranker_config(vocab)
    if model == "llama-3.1-8b":
        big = llama31_8b.CONFIG
        small = big.replace(attention_impl="xla_flash", flash_block_q=LLAMA_FLASH_BLOCK,
                            flash_block_k=LLAMA_FLASH_BLOCK)
        return (big, small, MINILM_CONFIG.replace(vocab_size=big.vocab_size),
                MINILM_CONFIG.replace(name="reranker", vocab_size=big.vocab_size))
    raise ValueError(f"unknown model {model!r}; known: {MODELS}")


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def build_embedder(model: str = "serve-tiny", *, device="cuda", vocab: int = 8192,
                   seed: int = 0):
    """(embedder params, embedder config): the stack's embedder alone, the
    initial weights ``build_stack`` draws (and then trains) for the same
    arguments."""
    dev = resolve_device(device)
    ecfg = model_configs(model, vocab)[2]
    return init_embedder(ecfg, _generator(dev, seed), dev), ecfg


def build_stack(*, model: str = "serve-tiny", device="cuda", vocab: int = 8192,
                capacity: int = 0, train_embedder_steps: int = 60, policy: str = "fifo",
                index: str = "flat", nclusters: int = 0, nprobe: int = 8,
                threshold: float = 0.7, band: float = 0.0, train_reranker_steps: int = 120,
                admit_floor: float = 0.0, max_new_tokens: int = 16, seed: int = 0):
    """Model stack + configs for one engine (``TweakLLMEngine(**stack)``).

    ``capacity`` 0 picks the stack's bank size (4096 tiny, 262,144 llama);
    ``nclusters`` 0 resolves from it (``core.index.resolve``).  The
    embedder trains for ``train_embedder_steps`` at batch 16; with ``band >
    0`` the reranker (init seed ``seed + 3``) trains for
    ``train_reranker_steps`` at batch 32 and is returned under ``reranker``.
    Training batches are drawn with seed 0, as the reference draws them.
    """
    dev = resolve_device(device)
    big_cfg, small_cfg, ecfg, rr_cfg = model_configs(model, vocab)
    vocab = big_cfg.vocab_size
    tok = HashWordTokenizer(vocab)
    eparams, ecfg = build_embedder(model, device=dev, vocab=vocab, seed=seed)
    if train_embedder_steps:
        eparams, _ = train_embedder(eparams, ecfg, tok, steps=train_embedder_steps, batch=16)
    gen_cfg = GenerateConfig(max_new_tokens=max_new_tokens,
                             sampler=SamplerConfig(vocab_size=vocab))
    big_m, small_m = build_model(big_cfg), build_model(small_cfg)
    big = Generator(big_m, big_m.init(_generator(dev, seed + 1), dev), gen_cfg)
    small = Generator(small_m, small_m.init(_generator(dev, seed + 2), dev), gen_cfg)
    if not capacity:
        capacity = LLAMA_CAPACITY if model == "llama-3.1-8b" else 4096
    cache_cfg = CacheConfig(capacity=capacity, dim=ecfg.d_model, policy=policy, index=index,
                            nclusters=nclusters, nprobe=nprobe)
    stack = dict(tokenizer=tok, embedder_params=eparams, embedder_cfg=ecfg, big=big,
                 small=small, cache_cfg=cache_cfg,
                 router_cfg=RouterConfig(tweak_threshold=threshold, band=band,
                                         admit_floor=admit_floor))
    if band > 0.0:
        rr_params = init_reranker(rr_cfg, _generator(dev, seed + 3), dev)
        if train_reranker_steps:
            rr_params, _ = train_reranker(rr_params, rr_cfg, tok, steps=train_reranker_steps)
        stack["reranker"] = (rr_params, rr_cfg)
    return stack


def build_engine(**kw) -> TweakLLMEngine:
    return TweakLLMEngine(**build_stack(**kw))


def build_replica_group(n: int, *, shared: bool = True, cache_shards: int = 0,
                        **kw) -> ReplicaGroup:
    """``n`` replicas over one shared bank (``shared=False``: a private bank
    each); the generators are shared handles.  ``cache_shards > 1``
    row-shards the bank over that many devices: the first CUDA devices, or
    that many CPU shards when ``device`` is the CPU."""
    stack = build_stack(**kw)
    mesh = None
    if cache_shards > 1:
        dev = stack["embedder_params"]["embed"].device
        mesh = make_cache_mesh(cache_shards,
                               devices=[dev] * cache_shards if dev.type == "cpu" else None)
    return ReplicaGroup.build(n, shared=shared, mesh=mesh, **stack)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8,
                    help="scheduler max_batch (unique queries per dispatch)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="simulated arrival rate (requests/s)")
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="scheduler coalescing deadline (simulated s)")
    ap.add_argument("--profile", default="lmsys", choices=["lmsys", "wildchat"])
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--cost-threshold", type=float, default=None,
                    help="routing operating point in [0,1] applied to every request; "
                         "default: the router's calibrated default cost")
    ap.add_argument("--band", type=float, default=0.0,
                    help="uncertainty band width around the TWEAK/MISS boundary; > 0 "
                         "enables the reranker second stage")
    ap.add_argument("--reranker-steps", type=int, default=120,
                    help="training steps for the cascade reranker (only with --band > 0)")
    ap.add_argument("--admit-floor", type=float, default=0.0,
                    help="IVF caches: suppress inserts of clusters whose hit EMA "
                         "falls below this (0 = admit everything)")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "lru", "lfu"])
    ap.add_argument("--index", default="flat", choices=["flat", "ivf"],
                    help="cache lookup index (ivf = clustered, DESIGN.md §7)")
    ap.add_argument("--embedder-steps", type=int, default=60,
                    help="contrastive training steps of the embedder")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas over ONE shared cache bank")
    ap.add_argument("--cache-shards", type=int, default=0,
                    help="row-shard the shared bank over this many devices (CUDA "
                         "devices, or CPU shards with --device cpu; 0 = local)")
    ap.add_argument("--private-caches", action="store_true",
                    help="give each replica a private bank (the degraded baseline)")
    ap.add_argument("--model", default="serve-tiny", choices=list(MODELS))
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    print(f"building TweakLLM stack ({args.model} on {args.device}, training the "
          f"embedder contrastively)...")
    kw = dict(model=args.model, device=args.device, threshold=args.threshold,
              policy=args.policy, index=args.index, train_embedder_steps=args.embedder_steps,
              band=args.band, train_reranker_steps=args.reranker_steps,
              admit_floor=args.admit_floor)
    scfg = SchedulerConfig(max_wait=args.max_wait, max_batch=args.batch, max_new_tokens=8,
                           cost_threshold=args.cost_threshold)
    if args.replicas > 1 or args.cache_shards > 1:
        group = build_replica_group(args.replicas, shared=not args.private_caches,
                                    cache_shards=args.cache_shards, **kw)
        sched = ReplicaScheduler(group.engines, scfg, clock=SimClock())
        eng, stats_src = group[0], group
    else:
        eng = stats_src = build_engine(**kw)
        sched = Scheduler(eng, scfg, clock=SimClock())
    wl = WorkloadGenerator(profile=args.profile, seed=0)
    texts = [q.text for q in wl.sample(args.queries)]
    trace = poisson_trace(texts, args.rate, seed=0)
    t0 = time.time()
    with torch.no_grad():
        done = replay_trace(sched, trace)
    dt = time.time() - t0
    # shedding (QueueFull) is a designed outcome under overload, not a bug
    if len(done) != len(texts) - sched.stats.rejected:
        raise RuntimeError(f"{len(done)} completions for {len(texts)} requests "
                           f"({sched.stats.rejected} rejected)")

    s, ss = stats_src.stats, sched.stats
    print(f"\n== TweakLLM serving report ({args.profile} profile) ==")
    print(f"requests: {ss.completed}  ({dt/max(ss.completed,1)*1e3:.1f} "
          f"ms/request wall on {eng.device.type})")
    print(f"scheduler: batches={ss.batches} mean_batch={ss.mean_batch:.1f} "
          f"dedup_joined={ss.joined} rejected={ss.rejected}")
    if args.replicas > 1:
        lanes = " ".join(f"r{i}:{lane.dispatched}d/{lane.batches}b+{lane.stolen_in}st"
                         for i, lane in enumerate(sched.lanes))
        print(f"replicas: {args.replicas} "
              f"({'shared' if not args.private_caches else 'private'} bank, "
              f"shards={max(args.cache_shards, 1)}) {lanes} stolen={ss.stolen}")
    print(f"routing: miss={s.miss} tweak={s.tweak} exact={s.exact} "
          f"hit_rate={s.hit_rate:.2%} (+{ss.joined} joined in flight)")
    if args.band > 0 or args.admit_floor > 0:
        cost = args.cost_threshold if args.cost_threshold is not None else "default"
        print(f"cascade: uncertain={s.uncertain} recovered={s.recovered} "
              f"suppressed_inserts={s.suppressed_inserts} (band={args.band} cost={cost})")
    print(f"tokens:  big={s.big_tokens} small={s.small_tokens}")
    print(f"cost:    {s.cost:,.0f} vs all-big {s.baseline_cost:,.0f} "
          f"-> {s.cost/max(s.baseline_cost,1):.2%} of baseline")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
