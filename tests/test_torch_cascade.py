"""The router cascade, the single-row insert, the GPTCache baseline and the
precision/recall metrics of the port against the JAX package's.

Stage 1 (``route_cascade`` at band > 0) and stage 2 (``stage2_combine``,
``cache.make_second_stage`` on flat and IVF banks) get the same inputs in
both frameworks: decisions, slots and the touched state are equal, ``conf``
within 1e-6.  An engine at band > 0 serves the JAX engine's trace with the
same weights (JAX ``build_stack``'s, the random reranker converted): equal
decisions, slots, responses and ``EngineStats``, both stage-2 outcomes
taken, every similarity and confidence more than 1e-3 from its threshold.
``GPTCacheBaseline.get`` returns the same texts, its score within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.core import RouterConfig as JaxRouterConfig
from repro.core import TweakLLMEngine as JaxEngine
from repro.core import baseline as jax_baseline
from repro.core import cache as jax_cache
from repro.core import index as jax_index
from repro.core import router as jax_router
from repro.eval import metrics as jax_metrics
from repro.launch.serve import build_stack as jax_build_stack
from repro.models.embedder import init_embedder as jax_init_embedder
from repro.models.reranker import init_reranker as jax_init_reranker
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro_torch.checkpoint import jax_cache_state_to_torch, jax_params_to_torch
from repro_torch.core import baseline, router
from repro_torch.core import cache as port_cache
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.eval import metrics
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.models.embedder import tiny_embedder_config
from repro_torch.models.reranker import tiny_reranker_config
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

DIM, QT, RT, VOCAB = 16, 6, 6, 512
RR_CFG = tiny_reranker_config(VOCAB)
RR_JAX = jax_init_reranker(jax.random.PRNGKey(3), RR_CFG)
RR_PORT = jax_params_to_torch(_flatten(RR_JAX), RR_CFG, device="cpu")


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ------------------------------------------------------------------ stage 1

def test_route_cascade_band_matches_jax():
    kw = dict(tweak_threshold=0.8, band=0.1)
    jcfg, pcfg = JaxRouterConfig(**kw), router.RouterConfig(**kw)
    rng = np.random.default_rng(0)
    cost = np.concatenate([np.full(40, 0.5), rng.random(40)]).astype(np.float32)
    tau = np.array(jax_router.threshold_for(jnp.asarray(cost), jcfg))
    top1 = (tau + rng.uniform(-0.2, 0.2, 80)).astype(np.float32)
    top1[::9] = 1.0                                   # EXACT keeps precedence
    edge = np.abs(np.abs(top1 - tau) - 0.05)
    top1 = np.where(edge < 1e-4, top1 + 1e-3, top1).astype(np.float32)
    want = np.asarray(jax_router.route_cascade(jnp.asarray(top1), jnp.asarray(tau), jcfg))
    got = router.route_cascade(torch.from_numpy(top1), torch.from_numpy(tau), pcfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {router.MISS, router.TWEAK, router.EXACT, router.UNCERTAIN}
    assert router.UNCERTAIN == jax_router.UNCERTAIN
    assert not (got[top1 >= 0.9999] == router.UNCERTAIN).any()


def test_router_config_defaults_match_jax():
    pick = {f.name for f in dataclasses.fields(router.RouterConfig)}
    assert pick == {f.name for f in dataclasses.fields(JaxRouterConfig)}
    assert dataclasses.asdict(router.RouterConfig()) == dataclasses.asdict(JaxRouterConfig())


# ------------------------------------------------------------------ stage 2

def test_stage2_combine_matches_jax_with_dead_rows():
    rng = np.random.default_rng(1)
    b, k = 8, 4
    live = rng.random((b, k)) < 0.8
    live[0] = False                                     # every candidate dead
    live[1] = [True, False, False, False]
    live[2, 0] = False                                  # the top-1 dead
    scores = np.where(live, rng.uniform(0.6, 1.0, (b, k)), -np.inf).astype(np.float32)
    logits = rng.normal(0, 2, (b, k)).astype(np.float32)
    tau = rng.uniform(0.7, 0.9, b).astype(np.float32)
    cfg = dict(w_agree=0.4, w_rerank=0.6, commit_at=0.45)
    jo = jax_router.stage2_combine(*map(jnp.asarray, (scores, logits, live, tau)),
                                   JaxRouterConfig(**cfg))
    po = router.stage2_combine(*map(torch.from_numpy, (scores, logits, live, tau)),
                               router.RouterConfig(**cfg))
    np.testing.assert_array_equal(po[0].numpy(), np.asarray(jo[0]))
    np.testing.assert_array_equal(po[1].numpy(), np.asarray(jo[1]))
    np.testing.assert_allclose(po[2].numpy(), np.asarray(jo[2]), rtol=0, atol=1e-6)
    assert po[1].dtype == torch.int32 and po[2].dtype == torch.float32
    assert int(po[1][0]) == 0 and float(po[2][0]) == 0.0 and not bool(po[0][0])
    assert po[0].any() and not po[0].all()


def _cfgs(index, capacity=32, **kw):
    base = dict(capacity=capacity, dim=DIM, max_query_tokens=QT, max_response_tokens=RT,
                topk=4, block_n=16, index=index, **kw)
    return jax_cache.CacheConfig(**base), port_cache.CacheConfig(**base)


def _rows(rng, n, embs):
    qm = (np.arange(QT)[None, :] < rng.integers(2, QT + 1, n)[:, None]).astype(np.float32)
    qt = np.where(qm > 0, rng.integers(5, VOCAB, (n, QT)), 0).astype(np.int32)
    return (embs, qt, qm, rng.integers(5, VOCAB, (n, RT)).astype(np.int32),
            np.ones((n, RT), np.float32))


@pytest.mark.parametrize("index,filled", [("flat", 30), ("flat", 3), ("ivf", 30)],
                         ids=["flat", "flat-sparse", "ivf"])
def test_second_stage_matches_jax(index, filled):
    rng = np.random.default_rng(2)
    jcfg, pcfg = _cfgs(index, policy="lru", **({"nclusters": 4} if index == "ivf" else {}))
    centers = _unit(rng, (5, DIM))
    embs = centers[rng.integers(0, 5, filled)] + 0.2 * _unit(rng, (filled, DIM))
    js = jax_cache.init_cache(jcfg)
    js, _ = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, _rows(rng, filled, embs)),
                                   filled)
    if index == "ivf":
        js = jax_index.build_index(js, jcfg, seed=0)
    ps = jax_cache_state_to_torch({k: np.asarray(v) for k, v in js.items()}, pcfg,
                                  device="cpu")
    kw = dict(tweak_threshold=0.85, band=0.25, commit_at=0.65)
    jr, pr = JaxRouterConfig(**kw), router.RouterConfig(**kw)
    b = 8
    q = centers[rng.integers(0, 5, b)] + 0.3 * _unit(rng, (b, DIM))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    q_t, q_m = _rows(rng, b, q)[1:3]
    scores, idx = map(np.array, jax_cache.lookup(js, jcfg, jnp.asarray(q)))
    idx = np.where(np.isfinite(scores), idx, -1).astype(np.int32)   # the port's dead slots
    cost = np.full(b, 0.5, np.float32)
    jst, jdec, jtau, jcl, _ = jax_cache.route_touch_core(
        js, jcfg, jr, jnp.asarray(q), jnp.asarray(scores), jnp.asarray(idx), jnp.asarray(cost))
    ps, pdec, ptau, pcl, _ = port_cache.route_touch_core(
        ps, pcfg, pr, torch.from_numpy(q), torch.from_numpy(scores), torch.from_numpy(idx),
        torch.from_numpy(cost))
    np.testing.assert_array_equal(pdec.numpy(), np.asarray(jdec))
    assert (pdec == router.UNCERTAIN).any()
    jfn = jax_cache.make_second_stage(jcfg, jr, RR_JAX, RR_CFG, donate=False)
    jst, jfinal, jslot, jconf = jfn(jst, jnp.asarray(q_t), jnp.asarray(q_m),
                                    jnp.asarray(scores), jnp.asarray(idx), jdec, jtau, jcl)
    pfn = port_cache.make_second_stage(pcfg, pr, RR_PORT, RR_CFG)
    ps, pfinal, pslot, pconf = pfn(ps, torch.from_numpy(q_t).long(), torch.from_numpy(q_m),
                                   torch.from_numpy(scores), torch.from_numpy(idx), pdec, ptau,
                                   pcl)
    np.testing.assert_array_equal(pfinal.numpy(), np.asarray(jfinal))
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(pconf.numpy(), np.asarray(jconf), rtol=0, atol=1e-6)
    unc = pdec.numpy() == router.UNCERTAIN
    assert np.abs(pconf.numpy()[unc] - 0.65).min() > 1e-3
    assert not (pfinal == router.UNCERTAIN).any()
    if filled > 4:     # both outcomes, and a committed row served off its top-1
        assert set(pfinal.numpy()[unc].tolist()) == {router.MISS, router.TWEAK}
        assert (pslot.numpy() != idx[:, 0]).any()
    for key, val in jst.items():
        want, got = np.asarray(val), ps[key].numpy()
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert np.array_equal(got, want), key


# ------------------------------------------------------------ single insert

@pytest.mark.parametrize("policy", ["fifo", "lru", "lfu"])
@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_single_insert_matches_jax_insert(policy, index):
    """Held to the reference's own ``insert`` (its insert_batch and insert
    differ by rounding on this JAX version)."""
    rng = np.random.default_rng(4)
    jcfg, pcfg = _cfgs(index, capacity=16, policy=policy,
                       **({"nclusters": 2, "ivf_bucket": 16} if index == "ivf" else {}))
    js = jax_cache.init_cache(jcfg)
    if index == "ivf":
        js, _ = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, _rows(rng, 6, _unit(
            rng, (6, DIM)))), 6)
        js = jax_index.build_index(js, jcfg, seed=1)
    ps = jax_cache_state_to_torch({k: np.asarray(v) for k, v in js.items()}, pcfg,
                                  device="cpu")
    for i in range(22):
        row = [a[0] for a in _rows(rng, 1, rng.standard_normal((1, DIM)).astype(np.float32))]
        assert int(port_cache._victim_slot(ps, pcfg)) == int(jax_cache._victim_slot(js, jcfg))
        js = jax_cache.insert(js, jcfg, *map(jnp.asarray, row))
        ps = port_cache.insert(ps, pcfg, *map(torch.from_numpy, row))
        if i % 3 == 0:                       # hits reorder the LRU/LFU victims
            hit = np.asarray([i % 16, (3 * i) % 16], np.int32)
            js = jax_cache.touch(js, jcfg, jnp.asarray(hit))
            ps = port_cache.touch(ps, pcfg, torch.from_numpy(hit))
        for key, val in js.items():
            want, got = np.asarray(val), ps[key].numpy()
            if key == "emb":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            else:
                assert np.array_equal(got, want), (i, key)


# ------------------------------------------------------------------ engine

ENG_VOCAB, CAPACITY, THRESHOLD, BAND, COMMIT_AT, MNT = 4096, 64, 0.95, 0.06, 0.4, 6


def _trace():
    g = QuestionPairGenerator(seed=4)
    cached = [g._random_query() for _ in range(6)]
    fresh = [g._random_query().text for _ in range(6)]
    pairs = ([q.text for q in cached],
             [synthesize_response(q.text, q.topic, q.intent) for q in cached])
    edit = lambda i: cached[i].text + " please"
    return pairs, [[cached[0].text, edit(1), fresh[0], fresh[1]],
                   [edit(2), fresh[0], fresh[2], cached[3].text, edit(4)],
                   [fresh[3], edit(5), fresh[1]], [cached[2].text, fresh[3]]]


def _port_engine(jstack, rcfg):
    big_cfg, small_cfg, ecfg, rr_cfg = model_configs("serve-tiny", ENG_VOCAB)
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name)
                                   for f in dataclasses.fields(cls)})
    gen_cfg = GenerateConfig(max_new_tokens=16, sampler=SamplerConfig(vocab_size=ENG_VOCAB))
    conv = lambda tree, cfg: jax_params_to_torch(_flatten(tree), cfg, device="cpu")
    gens = [Generator(build_model(c), conv(jstack[k].params, c), gen_cfg)
            for k, c in (("big", big_cfg), ("small", small_cfg))]
    rr_params, jrr_cfg = jstack["reranker"]
    assert dataclasses.asdict(jrr_cfg) == dataclasses.asdict(rr_cfg)
    return TweakLLMEngine(
        tokenizer=HashWordTokenizer(ENG_VOCAB),
        embedder_params=conv(jstack["embedder_params"], ecfg), embedder_cfg=ecfg,
        big=gens[0], small=gens[1], cache_cfg=pick(port_cache.CacheConfig, jstack["cache_cfg"]),
        router_cfg=pick(router.RouterConfig, rcfg), reranker=(conv(rr_params, rr_cfg), rr_cfg))


def test_cascade_engine_trace_matches_jax():
    jstack = jax_build_stack(vocab=ENG_VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD, band=BAND, train_reranker_steps=0)
    rcfg = JaxRouterConfig(tweak_threshold=THRESHOLD, band=BAND, commit_at=COMMIT_AT)
    jeng = JaxEngine(**dict(jstack, router_cfg=rcfg))
    peng = _port_engine(jstack, rcfg)
    assert jeng.bank.cascading and peng.bank.cascading
    confs = []
    stage2 = peng.bank.second_stage

    def recording(*args):
        final, slot, conf = stage2(*args)
        confs.extend(conf[args[4] == router.UNCERTAIN].tolist())
        return final, slot, conf

    peng.bank.second_stage = recording
    pairs, batches = _trace()
    jeng.populate(*pairs)
    peng.populate(*pairs)
    syncs = []
    for batch in batches:
        jr, jm = jeng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
        pr, pm = peng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
        for a, b in zip(pm, jm):
            assert min(abs(b["sim"] - THRESHOLD + s * BAND / 2) for s in (-1, 0, 1)) > 1e-3
            assert a == pytest.approx(b, abs=1e-5)
        assert pr == jr
        syncs.append((peng.last_route_syncs, any(m["stage2"] for m in pm)))
    assert all(n == 1 + s2 for n, s2 in syncs) and {s2 for _, s2 in syncs} == {False, True}
    assert min(abs(c - COMMIT_AT) for c in confs) > 1e-3
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    s = peng.stats
    assert s.uncertain == len(confs) >= 2 and 0 < s.recovered < s.uncertain
    for key in ("valid", "ptr", "size", "clock", "last_used", "hits", "q_tokens"):
        assert np.array_equal(peng.state[key].numpy(), np.asarray(jeng.state[key])), key
    assert peng.bank.text_store == jeng.bank.text_store


# ------------------------------------------------------------------ baseline

@pytest.mark.parametrize("rerank", ["cross_encoder", "none"])
def test_gptcache_baseline_matches_jax(rerank):
    ecfg = tiny_embedder_config(VOCAB)
    jemb = jax_init_embedder(jax.random.PRNGKey(0), ecfg)
    kw = dict(capacity=32, dim=ecfg.d_model, max_query_tokens=16, max_response_tokens=32)
    bcfg = dict(similarity_threshold=0.9, rerank=rerank)
    jb = jax_baseline.GPTCacheBaseline(
        tokenizer=JaxTokenizer(VOCAB), embedder_params=jemb, embedder_cfg=ecfg,
        reranker_params=RR_JAX, reranker_cfg=RR_CFG, cache_cfg=jax_cache.CacheConfig(**kw),
        cfg=jax_baseline.BaselineConfig(**bcfg), max_query_len=16)
    pb = baseline.GPTCacheBaseline(
        tokenizer=HashWordTokenizer(VOCAB),
        embedder_params=jax_params_to_torch(_flatten(jemb), ecfg, device="cpu"),
        embedder_cfg=ecfg, reranker_params=RR_PORT, reranker_cfg=RR_CFG,
        cache_cfg=port_cache.CacheConfig(**kw), cfg=baseline.BaselineConfig(**bcfg),
        max_query_len=16)
    g = QuestionPairGenerator(seed=6)
    cached = [g._random_query() for _ in range(8)]
    for q in cached:
        resp = synthesize_response(q.text, q.topic, q.intent)
        jb.put(q.text, resp)
        pb.put(q.text, resp)
    assert pb._texts == jb._texts
    queries = ([q.text for q in cached[:3]] + [q.text + " please" for q in cached[3:6]]
               + [g._random_query().text for _ in range(6)])
    outcomes = set()
    for text in queries:
        jq, jr, js = jb.get(text)
        pq, pr, ps = pb.get(text)
        assert (pq, pr) == (jq, jr)
        assert abs(ps - js) <= 1e-5 and abs(js - 0.9) > 1e-3
        outcomes.add(pq is None)
    assert outcomes == {True, False}
    for key, val in jb.state.items():
        want, got = np.asarray(val), pb.state[key].numpy()
        if key == "emb":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got, want), key


def test_precision_recall_matches_jax():
    rng = np.random.default_rng(7)
    scores = rng.random(200)
    labels = rng.random(200) < 0.4
    thr = np.linspace(0, 1, 11)
    hits = scores >= 0.5
    assert metrics.precision_recall(hits, labels) == jax_metrics.precision_recall(hits, labels)
    assert metrics.pr_curve(scores, labels, thr) == jax_metrics.pr_curve(scores, labels, thr)
    assert metrics.precision_recall(np.zeros(3, bool), np.zeros(3, bool)) == (0.0, 0.0)
