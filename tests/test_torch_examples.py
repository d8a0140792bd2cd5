"""The reference's three examples on the port (``repro_torch.examples``)
against the JAX package's on the CPU.

* ``cache_policy_study``: the reference's own ``run_policy`` (imported from
  ``examples/cache_policy_study.py`` by path) and the port's give the same
  hit sequence and rate for FIFO, LRU and LFU on the same unit embeddings;
* ``serve_e2e``: the example's engine and ``Scheduler`` on a ``SimClock``,
  the JAX package's and the port's on the same weights (JAX init, converted)
  and the same Poisson trace, give equal responses, ``EngineStats`` and
  ``SchedulerStats``;
* ``quickstart``: the five routing decisions equal with the same embedder;
* each port example's ``main`` runs end to end with ``--device cpu``.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.core import CacheConfig as JaxCacheConfig
from repro.core import RouterConfig as JaxRouterConfig
from repro.core import TweakLLMEngine as JaxEngine
from repro.core import cache as jax_cache
from repro.data import WorkloadGenerator as JaxWorkload
from repro.launch.serve import build_stack as jax_build_stack
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models.embedder import init_embedder as jax_init_embedder
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro.serving import Scheduler as JaxScheduler
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import SimClock as JaxSimClock
from repro.serving import poisson_trace as jax_poisson_trace
from repro.serving import replay_trace as jax_replay_trace
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.checkpoint.convert import torch_params_to_jax
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.examples import cache_policy_study, quickstart, serve_e2e
from repro_torch.launch.serve import build_stack
from repro_torch.models import build_model
from repro_torch.models.embedder import tiny_embedder_config
from repro_torch.tokenizer import HashWordTokenizer
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ cache_policy_study

class _Rows:
    """Rows of an array that remember the last index read: the reference's
    ``run_policy`` reads ``embs[i]`` for row i's lookup, so a ``touch`` call
    (a hit) comes right after the read of the row that hit."""

    def __init__(self, a):
        self.a, self.shape, self.last = a, a.shape, None

    def __getitem__(self, i):
        self.last = i
        return self.a[i]


def _policy_workload(n=200, topics=60, dim=64, seed=0):
    """``n`` unit embeddings: Zipf-drawn topics, each query its topic's unit
    vector plus noise (cosine to another query of its topic ~0.9, to another
    topic's ~0 +- 0.13: far from the 0.7 threshold on both sides)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((topics, dim))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    p = 1.0 / np.arange(1, topics + 1)
    idx = rng.choice(topics, size=n, p=p / p.sum())
    noise = rng.standard_normal((n, dim))
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    x = base[idx] + 0.3 * noise
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def reference_policy():
    return _reference_example("cache_policy_study")


@pytest.mark.parametrize("capacity", [24, 96])
def test_policy_hits_equal_the_reference(reference_policy, monkeypatch, capacity):
    embs = _policy_workload()
    seqs = {}
    for policy in ("fifo", "lru", "lfu"):
        rows, hits = _Rows(embs), []
        inner = jax_cache.touch

        def touch(state, cfg, idx, _inner=inner, _rows=rows, _hits=hits):
            _hits.append(_rows.last)
            return _inner(state, cfg, idx)

        monkeypatch.setattr(reference_policy.cache_lib, "touch", touch)
        rate = reference_policy.run_policy(policy, rows, capacity=capacity)
        monkeypatch.setattr(reference_policy.cache_lib, "touch", inner)
        want = np.zeros(len(embs), bool)
        want[hits] = True
        got = cache_policy_study.run_policy(policy, torch.from_numpy(embs), capacity)
        assert got == want.tolist(), policy
        assert sum(got) / len(got) == pytest.approx(rate, abs=1e-12)
        seqs[policy] = tuple(got)
    assert 0 < sum(seqs["fifo"]) < len(embs)
    if capacity == 24:     # evictions: the policies keep different rows
        assert len(set(seqs.values())) > 1


# --------------------------------------------------------------- serve_e2e

VOCAB, QUERIES, BATCH, MNT = 8192, 24, 8, 4


@pytest.fixture(scope="module")
def serve_pair():
    """The example's engine (two fp32 LMs at its widths, the tiny embedder,
    a 1,024-row bank, TWEAK at 0.7) in both packages on the JAX init's
    weights, untrained (the pretraining is not what is compared)."""
    big_cfg, small_cfg = serve_e2e.lm_configs(VOCAB)
    ecfg = tiny_embedder_config(VOCAB)
    jtok = JaxTokenizer(VOCAB)
    jcfg = JaxGenerateConfig(max_new_tokens=MNT, sampler=JaxSamplerConfig(vocab_size=VOCAB))
    jax_models, port_models = [], []
    for cfg, seed in ((big_cfg, 1), (small_cfg, 2)):
        jm = jax_build_model(JaxModelConfig(**cfg.__dict__))
        jp = jm.init(jax.random.PRNGKey(seed))
        jax_models.append(JaxGenerator(jm, jp, jcfg))
        port_models.append((build_model(cfg),
                            jax_params_to_torch(_flatten(jp), cfg, device="cpu")))
    jep = jax_init_embedder(jax.random.PRNGKey(0), ecfg)
    jeng = JaxEngine(tokenizer=jtok, embedder_params=jep, embedder_cfg=ecfg,
                     big=jax_models[0], small=jax_models[1],
                     cache_cfg=JaxCacheConfig(capacity=1024, dim=ecfg.d_model),
                     router_cfg=JaxRouterConfig(tweak_threshold=0.7))
    peng = serve_e2e.build_engine(HashWordTokenizer(VOCAB), *port_models,
                                  jax_params_to_torch(_flatten(jep), ecfg, device="cpu"),
                                  ecfg, max_new_tokens=MNT)
    return jeng, peng


def test_serve_e2e_trace_equals_the_reference(serve_pair):
    jeng, peng = serve_pair
    texts, trace = serve_e2e.workload(QUERIES)
    want_texts = [q.text for q in JaxWorkload(profile="lmsys", seed=0).sample(QUERIES)]
    assert texts == want_texts
    assert trace == jax_poisson_trace(want_texts, rate=100.0, seed=0)
    jsched = JaxScheduler(jeng, JaxSchedulerConfig(max_wait=0.1, max_batch=BATCH,
                                                   max_new_tokens=MNT),
                          clock=JaxSimClock())
    jdone = jax_replay_trace(jsched, trace)
    pdone, psched, _ = serve_e2e.replay(peng, trace, BATCH, max_new_tokens=MNT)
    assert len(pdone) == len(jdone) == QUERIES - jsched.stats.rejected
    key = lambda r: r.rid
    assert ([(r.rid, r.text, r.response, r.joined, r.arrival, r.finish)
             for r in sorted(pdone, key=key)]
            == [(r.rid, r.text, r.response, r.joined, r.arrival, r.finish)
                for r in sorted(jdone, key=key)])
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    assert dataclasses.asdict(psched.stats) == dataclasses.asdict(jsched.stats)
    s = peng.stats
    assert s.miss and s.tweak and s.miss + s.tweak + s.exact == psched.stats.dispatched


# -------------------------------------------------------------- quickstart

def _jax_tree(like, flat):
    """The reference's parameter tree ``like`` with its leaves taken from the
    port's ``torch_params_to_jax`` output (layers stacked under ``scan/0/``
    there, under ``scan/`` in the embedder's tree)."""
    def leaf(path, _):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        return jax.numpy.asarray(flat["scan/0/" + key[5:] if key.startswith("scan/") else key])
    return jax.tree_util.tree_map_with_path(leaf, like)


def test_quickstart_decisions_equal_the_reference():
    """The quickstart's stack (``build_engine(train_embedder_steps=40,
    capacity=256)``) in both packages with the same embedder, the port's
    trained one converted to the reference's layout: the same five routes,
    similarities within 1e-5 (each away from the thresholds)."""
    stack = build_stack(device="cpu", capacity=256, train_embedder_steps=40)
    jstack = jax_build_stack(train_embedder_steps=0, capacity=256)
    jstack["embedder_params"] = _jax_tree(
        jstack["embedder_params"], torch_params_to_jax(stack["embedder_params"],
                                                       stack["embedder_cfg"]))
    jeng = JaxEngine(**jstack)
    want = []
    for q in quickstart.QUERIES:
        _, meta = jeng.handle_batch([q], max_new_tokens=8, collect_meta=True)
        want.append(meta[0])
    got = quickstart.route_queries(TweakLLMEngine(**stack))
    assert [m["decision"] for m in got] == [m["decision"] for m in want]
    for g, w in zip(got, want):
        assert min(abs(w["sim"] - 0.7), abs(w["sim"] - 0.9999)) > 5e-5
        assert g["sim"] == pytest.approx(w["sim"], abs=1e-5)
    assert {m["decision"] for m in got} == {0, 1, 2}


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("name,argv,lines", [
    ("quickstart", [], ("routing: miss=", "cost: ")),
    ("serve_e2e", ["--queries", "16", "--steps", "3"],
     ("requests 16 in", "scheduler: batches=", "routing: miss=", "generated tokens:",
      "cost: ")),
    ("cache_policy_study", [], ("FIFO  hit rate:", "LRU   hit rate:", "LFU   hit rate:")),
])
def test_example_main_runs_on_the_cpu(capsys, name, argv, lines):
    mod = {"quickstart": quickstart, "serve_e2e": serve_e2e,
           "cache_policy_study": cache_policy_study}[name]
    assert mod.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out[-600:])
