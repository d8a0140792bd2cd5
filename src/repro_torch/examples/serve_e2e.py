"""End-to-end serving example: a TweakLLM deployment with real generation
(counterpart of the reference's ``examples/serve_e2e.py``).

Pretrains tiny Big/Small fp32 LMs on the synthetic corpus (big deeper than
small), trains the embedder contrastively, then replays a Poisson arrival
trace of a Zipfian workload through the continuous-batching scheduler
(DESIGN.md §6) over the full router: misses generate with the Big LM and
populate the cache, paraphrase hits run the Appendix-A tweak prompt through
the Small LM, exact repeats return verbatim, and identical in-flight
requests join one dispatch.  On the card the Big LM decodes through the
dense decode kernel at head dim 16 and the Small LM at head dim 24.

  PYTHONPATH=src python -m repro_torch.examples.serve_e2e [--queries 120] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import WorkloadGenerator, token_stream_batches
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.embedder import init_embedder, tiny_embedder_config
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig, SimClock, poisson_trace,
                                           replay_trace)
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.embedder_train import train_embedder

VOCAB = 8192
MAX_NEW_TOKENS = 12


def lm_configs(vocab: int = VOCAB):
    """(big, small): 4L d128 8H/4kv (dh 16), and 2L d96 4H/2kv (dh 24) with
    fixed 32-token flash blocks, which qualify it for the engine's
    shared-prefix KV reuse on TWEAK hits (DESIGN.md §9); both fp32."""
    big = ModelConfig(name="big-lm", num_layers=4, d_model=128, num_heads=8, num_kv_heads=4,
                      d_ff=256, vocab_size=vocab, max_seq_len=1024, dtype="float32")
    small = big.replace(name="small-lm", num_layers=2, d_model=96, num_heads=4,
                        num_kv_heads=2, d_ff=192, attention_impl="xla_flash",
                        flash_block_q=32, flash_block_k=32)
    return big, small


def pretrain_lm(cfg, steps: int, seed: int, tok, device):
    """``steps`` AdamW steps (lr 3e-3) on 8 x 64-token batches of the
    synthetic corpus; prints the first and last loss, returns ``(model,
    params)``."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    step = make_train_step(model, AdamWConfig(lr=3e-3), total_steps=steps)
    opt = init_opt_state(params)
    stream = token_stream_batches(tok, 8, 64, seed=seed)
    first = last = None
    for _ in range(steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        last = float(m["loss"])
        first = first if first is not None else last
    print(f"  {cfg.name}: loss {first:.2f} -> {last:.2f} over {steps} steps")
    return model, params


def build_engine(tok, big, small, eparams, ecfg, max_new_tokens: int = MAX_NEW_TOKENS):
    """The example's engine: ``big`` and ``small`` are (model, params); a
    FIFO bank of 1,024 rows, TWEAK at similarity 0.7."""
    gen_cfg = GenerateConfig(max_new_tokens=max_new_tokens,
                             sampler=SamplerConfig(vocab_size=tok.vocab_size))
    return TweakLLMEngine(
        tokenizer=tok, embedder_params=eparams, embedder_cfg=ecfg,
        big=Generator(*big, gen_cfg), small=Generator(*small, gen_cfg),
        cache_cfg=CacheConfig(capacity=1024, dim=ecfg.d_model),
        router_cfg=RouterConfig(tweak_threshold=0.7))


def workload(queries: int):
    """The reference's trace: ``queries`` LMSYS-profile queries arriving as
    a Poisson process at 100 requests a simulated second."""
    wl = WorkloadGenerator(profile="lmsys", seed=0)  # seed: ok example, reproducible trace
    texts = [q.text for q in wl.sample(queries)]
    return texts, poisson_trace(texts, rate=100.0, seed=0)  # seed: ok example trace


def replay(eng, trace, batch: int, max_new_tokens: int = MAX_NEW_TOKENS):
    """The trace through a ``Scheduler`` (max wait 0.1 s, ``batch`` unique
    queries a dispatch) on a ``SimClock``; returns (completed requests, the
    scheduler, wall seconds)."""
    sched = Scheduler(eng, SchedulerConfig(max_wait=0.1, max_batch=batch,
                                           max_new_tokens=max_new_tokens),
                      clock=SimClock())
    t0 = time.time()
    with torch.no_grad():
        done = replay_trace(sched, trace)
    return done, sched, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tok = HashWordTokenizer(VOCAB)
    print(f"pretraining Big and Small LMs on the synthetic corpus ({dev.type})...")
    big_cfg, small_cfg = lm_configs()
    big = pretrain_lm(big_cfg, args.steps, 1, tok, dev)
    small = pretrain_lm(small_cfg, args.steps, 2, tok, dev)

    print("training embedder contrastively...")
    ecfg = tiny_embedder_config(VOCAB)
    # seed: ok example, the reference's PRNGKey(0) init
    eparams = init_embedder(ecfg, torch.Generator(device=dev).manual_seed(0), dev)
    eparams, losses = train_embedder(eparams, ecfg, tok, steps=60, batch=16)
    print(f"  InfoNCE {losses[0]:.2f} -> {losses[-1]:.2f}")

    eng = build_engine(tok, big, small, eparams, ecfg)
    texts, trace = workload(args.queries)
    print(f"replaying {args.queries} arrivals through the scheduler "
          f"(max_batch={args.batch})...")
    done, sched, dt = replay(eng, trace, args.batch)
    if len(done) != len(texts) - sched.stats.rejected:
        raise RuntimeError(f"{len(done)} completions for {len(texts)} requests "
                           f"({sched.stats.rejected} rejected)")

    s, ss = eng.stats, sched.stats
    print("\n== serving report ==")
    print(f"requests {ss.completed} in {dt:.1f}s "
          f"({dt/max(ss.completed,1)*1e3:.0f} ms/req wall on {dev.type})")
    print(f"scheduler: batches={ss.batches} mean_batch={ss.mean_batch:.1f} "
          f"dedup_joined={ss.joined} rejected={ss.rejected} dispatched={ss.dispatched}")
    print(f"routing: miss={s.miss} tweak={s.tweak} exact={s.exact} "
          f"(hit rate {s.hit_rate:.1%})")
    print(f"generated tokens: big={s.big_tokens} small={s.small_tokens}")
    print(f"cost: {s.cost:,.0f} vs all-big {s.baseline_cost:,.0f} "
          f"= {s.cost/max(s.baseline_cost,1):.1%} of baseline "
          f"(paper: 35% on LMSYS)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
