"""Builds the system under test from a configuration file: the benchmark's
weights for both language models and the embedder, the embedder trained
contrastively by the benchmark's own code, and the program's serving stack
(``TweakLLMEngine`` over a FIFO flat bank, a ``Scheduler`` in barrier mode
on a ``WallClock``) wrapped for the harness's spans.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import questions, record, reference, weights
from .tokenizer import HashWordTokenizer

# the embedder's weights and training batches: one embedder for every run,
# so that every seed routes the same traffic the same way (EXACT, TWEAK,
# MISS) and serves the same work
EMBEDDER_SEED = 20_240_618

# the keys of a model's section that are not ModelConfig fields
META = ("source", "published", "assumed", "notes", "deployment")


def model_fields(section: dict) -> dict:
    """A model's section of a configuration file, the keys its ModelConfig
    takes (lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in section.items()
            if k not in META and not isinstance(v, dict)}


def sections(cfg: dict):
    """(big, small, embedder, serving) of a configuration file: the big
    model's keys sit at the top level, the rest in their groups."""
    big = {k: v for k, v in cfg.items() if k not in ("small", "embedder", "serving")}
    return model_fields(big), model_fields(cfg["small"]), model_fields(cfg["embedder"]), \
        cfg["serving"]


def triples(seed: int, tok: HashWordTokenizer, steps: int, batch: int, device):
    """Training batches of (anchor, paraphrase, hard negative) from the
    frozen question generator."""
    gen = questions.QuestionPairGenerator(seed)
    for _ in range(steps):
        rows = [gen.triple() for _ in range(batch)]
        out = []
        for j in range(3):
            t, m = tok.encode_batch([r[j].text for r in rows], 32)
            out += [torch.from_numpy(t).long().to(device), torch.from_numpy(m).to(device)]
        yield out


@dataclasses.dataclass
class Stack:
    engine: object           # the program's TweakLLMEngine
    entry: object            # what the scheduler calls (record.EngineEntry)
    sched: object            # the program's Scheduler
    log: record.Log
    big: dict                # the benchmark's weights, for the reference
    small: dict
    embedder: dict
    cfg: dict                # big, small, embedder, serving sections
    phases: dict             # set-up seconds by phase


def build(cfg_file: dict, seed: int, device) -> Stack:
    """The stack of a configuration at ``seed``.  Weights: big model from
    seed * 4 + 1, small + 2 (one generator on the device each); the
    embedder's weights and training batches from ``EMBEDDER_SEED``."""
    from repro_torch.core.cache import CacheConfig
    from repro_torch.core.engine import TweakLLMEngine
    from repro_torch.core.router import RouterConfig
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.serving.generate import GenerateConfig, Generator
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, WallClock
    from repro_torch.tokenizer import HashWordTokenizer as ProgramTokenizer

    big, small, emb, serving = sections(cfg_file)
    phases = {}
    t = time.monotonic()

    def gen(s):
        g = torch.Generator(device=device)
        g.manual_seed(s)
        return g

    wb = weights.make(weights.lm_leaves(big), gen(seed * 4 + 1), device)
    ws = weights.make(weights.lm_leaves(small), gen(seed * 4 + 2), device)
    we = weights.make(weights.embedder_leaves(emb), gen(EMBEDDER_SEED), device)
    _sync(device)
    phases["weights"] = time.monotonic() - t
    t = time.monotonic()
    vocab = small["vocab_size"]
    reference.train_embedder(we, emb, triples(EMBEDDER_SEED, HashWordTokenizer(vocab),
                                              serving["embedder_steps"],
                                              serving["embedder_batch"], device),
                             lr=serving["embedder_lr"])
    _sync(device)
    phases["embedder"] = time.monotonic() - t

    # optional serving keys, so that a later cell is a data file: the paged
    # KV pool, speculative TWEAK decode, the clustered index
    gcfg = GenerateConfig(max_new_tokens=serving["max_new_tokens"],
                          sampler=SamplerConfig(vocab_size=vocab),
                          paged=serving.get("paged", False))
    scfg = dataclasses.replace(gcfg, spec_k=serving.get("spec_k", 1))
    bm, sm = build_model(ModelConfig(**big)), build_model(ModelConfig(**small))
    engine = TweakLLMEngine(
        tokenizer=ProgramTokenizer(vocab), embedder_params=we,
        embedder_cfg=ModelConfig(**emb), big=Generator(bm, wb, gcfg),
        small=Generator(sm, ws, scfg),
        cache_cfg=CacheConfig(capacity=serving["bank_rows"], dim=emb["d_model"],
                              index=serving.get("index", "flat"),
                              nclusters=serving.get("nclusters", 0),
                              nprobe=serving.get("nprobe", 8)),
        router_cfg=RouterConfig(tweak_threshold=serving["tweak_threshold"]),
        max_query_len=serving["max_query_len"])
    log = record.Log()
    entry = record.attach(engine, log)
    sched = Scheduler(entry, SchedulerConfig(max_wait=serving["max_wait_s"],
                                             max_batch=serving["max_batch"],
                                             max_new_tokens=serving["max_new_tokens"]),
                      clock=WallClock())
    return Stack(engine, entry, sched, log, wb, ws, we,
                 {"big": big, "small": small, "embedder": emb, "serving": serving}, phases)


def fill_bank(stack: Stack, warm, chunk: int = 4096) -> None:
    """The warm set into the bank through the program's ``populate``."""
    for i in range(0, len(warm), chunk):
        part = warm[i:i + chunk]
        stack.engine.populate([w[0] for w in part], [w[1] for w in part])


def warm_up(stack: Stack, texts, device) -> None:
    """Serve the warm-up texts in full dispatches and build the small
    model's instruction-prefix KV for every batch bucket up to the
    dispatch size, so nothing is built inside the window."""
    from repro_torch.serving.batcher import BATCH_BUCKETS
    eng = stack.engine
    mb = stack.cfg["serving"]["max_batch"]
    if eng._prefix_path_available():
        for b in BATCH_BUCKETS:
            if b <= mb:
                eng._small_prefix_cache(b)
    for i in range(0, len(texts), mb):
        for text in texts[i:i + mb]:
            stack.sched.submit(text)
        stack.sched.flush()
    _sync(device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def stats_copy(stats):
    return dataclasses.replace(stats)
