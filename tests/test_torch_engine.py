"""The port's serving engine against the JAX package's on one greedy trace.

Both engines get the same weights (the JAX ``build_stack`` serve-tiny
models and embedder, converted), the same populated pairs and the same
batches of exact repeats, one-word edits and fresh queries from
``data/questions.py``: routing decisions, similarities, responses,
``EngineStats`` and the bank state must agree, with all three routes taken.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.launch.serve import build_stack as jax_build_stack
from repro.core import TweakLLMEngine as JaxEngine
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.launch.serve import build_engine, build_replica_group, model_configs
from repro_torch.models import build_model
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

VOCAB, CAPACITY, THRESHOLD, MNT = 4096, 64, 0.96, 6


def _port_configs(jstack):
    """The port's cache and router configs with the JAX stack's settings."""
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name)
                                   for f in dataclasses.fields(cls)})
    return pick(CacheConfig, jstack["cache_cfg"]), pick(RouterConfig, jstack["router_cfg"])


def _port_engine(jstack):
    big_cfg, small_cfg, ecfg, _ = model_configs("serve-tiny", VOCAB)
    cache_cfg, router_cfg = _port_configs(jstack)
    gen_cfg = GenerateConfig(max_new_tokens=16, sampler=SamplerConfig(vocab_size=VOCAB))
    gens = [Generator(build_model(c),
                      jax_params_to_torch(_flatten(jstack[k].params), c, device="cpu"),
                      gen_cfg) for k, c in (("big", big_cfg), ("small", small_cfg))]
    return TweakLLMEngine(
        tokenizer=HashWordTokenizer(VOCAB),
        embedder_params=jax_params_to_torch(_flatten(jstack["embedder_params"]), ecfg,
                                            device="cpu"),
        embedder_cfg=ecfg, big=gens[0], small=gens[1],
        cache_cfg=cache_cfg, router_cfg=router_cfg)


def _trace():
    g = QuestionPairGenerator(seed=4)
    cached = [g._random_query() for _ in range(6)]
    fresh = [g._random_query().text for _ in range(6)]
    pairs = ([q.text for q in cached],
             [synthesize_response(q.text, q.topic, q.intent) for q in cached])
    edit = lambda i: cached[i].text + " please"
    batches = [[cached[0].text, edit(1), fresh[0], fresh[1]],
               [edit(2), fresh[0], fresh[2], cached[3].text, edit(4)],
               [fresh[3], edit(5), fresh[1]]]
    return pairs, batches


@pytest.fixture(scope="module")
def engines():
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    return JaxEngine(**jstack), _port_engine(jstack)


def test_engine_trace_matches_jax(engines):
    jeng, peng = engines
    pairs, batches = _trace()
    jeng.populate(*pairs)
    peng.populate(*pairs)
    seen = set()
    for batch in batches:
        jr, jm = jeng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
        pr, pm = peng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
        for a, b in zip(pm, jm):
            # decisions are compared away from the thresholds only
            assert min(abs(b["sim"] - THRESHOLD), abs(b["sim"] - 0.9999)) > 5e-5
            assert a["decision"] == b["decision"]
            assert a["sim"] == pytest.approx(b["sim"], abs=1e-5)
            assert (a["band"], a["gen_tokens"], a["cost"]) == (b["band"], b["gen_tokens"],
                                                               b["cost"])
        assert pr == jr
        seen |= {m["decision"] for m in pm}
    assert seen == {router.MISS, router.TWEAK, router.EXACT}
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    s = peng.stats
    assert s.big_tokens + s.small_tokens <= s.total * MNT
    for key in ("valid", "ptr", "size", "clock", "last_used", "hits", "q_tokens",
                "r_tokens", "r_mask"):
        assert np.array_equal(peng.state[key].numpy(), np.asarray(jeng.state[key])), key
    np.testing.assert_allclose(peng.state["emb"].numpy(), np.asarray(jeng.state["emb"]),
                               atol=1e-5)
    assert peng.bank.text_store == jeng.bank.text_store


def test_unservable_budget_fails_before_any_state_change(engines):
    _, peng = engines
    clock = int(peng.state["clock"])
    with pytest.raises(ValueError):
        peng.handle_batch(["anything"], max_new_tokens=2000)
    assert int(peng.state["clock"]) == clock


def test_build_engine_serves_on_cpu_and_refuses_off_slice():
    eng = build_engine(model="serve-tiny", device="cpu", capacity=32, train_embedder_steps=0)
    eng.populate(["how do i learn rust"], ["practice"])
    out, meta = eng.handle_batch(["how do i learn rust", "what is origami"],
                                 max_new_tokens=3, collect_meta=True)
    assert meta[0]["decision"] == router.EXACT and out[0] == "practice"
    assert eng.stats.total == 2 and eng.big.device == torch.device("cpu")
    # embedder training and the cascade run; the trained embedder moved
    trained = build_engine(model="serve-tiny", device="cpu", capacity=32,
                           train_embedder_steps=5)
    assert not torch.equal(trained.embedder_params["embed"], eng.embedder_params["embed"])
    cascade = build_engine(model="serve-tiny", device="cpu", capacity=32, band=0.1,
                           train_embedder_steps=0, train_reranker_steps=2)
    assert cascade.bank.cascading and not eng.bank.cascading
    group = build_replica_group(2, model="serve-tiny", device="cpu", capacity=32,
                                train_embedder_steps=0)
    assert len(group) == 2 and group.shared and group[1].replica_id == 1
    private = build_replica_group(2, shared=False, cache_shards=2, model="serve-tiny",
                                  device="cpu", capacity=32, train_embedder_steps=0)
    assert not private.shared and all(e.bank.sharded for e in private.engines)
    with pytest.raises(ValueError):
        build_engine(model="gpt-9", device="cpu")
