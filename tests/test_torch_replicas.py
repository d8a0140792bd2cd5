"""The port's replica serving against the JAX package's on one ``SimClock``
trace.

* ``ReplicaScheduler`` over deterministic engine doubles: completions
  (response, finish time, joined flag, meta), fleet stats, per-lane
  dispatches, batches and steals, and the engine calls of every lane equal
  the JAX scheduler's, barrier and continuous, with and without stealing,
  from a drifted queue and under shedding.
* ``ReplicaGroup`` with a shared bank and with private banks, the same
  weights on both sides (the JAX ``build_stack`` serve-tiny models and
  embedder, converted): the same responses, decisions, aggregate
  ``EngineStats``, lane counters and bank states; a MISS committed by one
  replica is an EXACT hit on the other only when the bank is shared; a
  group over a bank sharded on 2 CPU shards serves the same trace; no KV
  page leaks.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import ReplicaGroup as JaxReplicaGroup
from repro.launch.serve import build_stack as jax_build_stack
from repro.serving import scheduler as jax_sched
from repro.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.distributed import gather_cache_state
from repro_torch.core.engine import EngineStats, ReplicaGroup, TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.serving import scheduler as port_sched
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

VOCAB, CAPACITY, THRESHOLD, MNT = 4096, 64, 0.96, 4


# ------------------------------------------------------- scheduler lanes
@dataclasses.dataclass
class _Result:
    responses: list
    meta: list
    big_tokens: int
    small_tokens: int


class _Engine:
    """Deterministic engine double: the response and token counts are
    functions of the text alone."""

    def __init__(self):
        self.calls = []

    def handle_batch_result(self, texts, *, max_new_tokens, cost_thresholds=None):
        self.calls.append((tuple(texts), cost_thresholds))
        meta = [{"decision": len(t) % 3, "sim": 0.5, "gen_tokens": len(t) % max_new_tokens}
                for t in texts]
        return _Result([t.upper() for t in texts], meta,
                       sum(m["gen_tokens"] for m in meta if m["decision"] == 0),
                       sum(m["gen_tokens"] for m in meta if m["decision"] != 0))


def _replay(mod, n_lanes, cfg_kw, service, drift):
    engines = [_Engine() for _ in range(n_lanes)]
    sched = mod.ReplicaScheduler(engines, mod.SchedulerConfig(**cfg_kw), clock=mod.SimClock(),
                                 service_model=service)
    if drift:
        # a drifted queue (a stalled replica): everything piles on lane 0
        for i in range(6):
            sched.submit(f"drifted request {i} on topic {i % 4}")
        for lane in sched.lanes[1:]:
            sched.lanes[0].groups += lane.groups
            lane.groups.clear()
    texts = [f"query {i % 13} about topic {i % 5}" for i in range(40)]
    done = sorted(mod.replay_trace(sched, mod.poisson_trace(texts, 150.0, seed=3)),
                  key=lambda r: r.rid)
    return (sched, [e.calls for e in engines],
            [(r.rid, r.text, r.response, r.joined, r.finish, r.latency, r.meta) for r in done])


@pytest.mark.parametrize("n_lanes,cfg_kw,drift", [
    (2, dict(max_batch=4, max_wait=0.02), False),
    (3, dict(max_batch=2, max_wait=0.01), True),
    (2, dict(max_batch=2, max_wait=0.0, steal=False), True),
    (2, dict(max_batch=4, queue_capacity=3), False),
    (2, dict(continuous=True, slots=2), True),
    (3, dict(continuous=True, slots=2, cost_threshold=0.3, dedup=False), False),
], ids=["barrier", "barrier-steal", "no-steal", "shedding", "continuous-steal",
        "continuous-cost"])
def test_replica_scheduler_matches_jax(n_lanes, cfg_kw, drift):
    service = lambda b: 0.004 * b + 0.01
    js, jcalls, jdone = _replay(jax_sched, n_lanes, cfg_kw, service, drift)
    ps, pcalls, pdone = _replay(port_sched, n_lanes, cfg_kw, service, drift)
    assert pdone == jdone and pcalls == jcalls
    assert dataclasses.asdict(ps.stats) == dataclasses.asdict(js.stats)
    lane = lambda ln: (ln.dispatched, ln.batches, ln.stolen_in, ln.busy_until, ln.slot_free)
    assert [lane(x) for x in ps.lanes] == [lane(x) for x in js.lanes]
    assert ps.stats.completed == ps.stats.submitted
    if drift and cfg_kw.get("steal", True):
        assert ps.stats.stolen > 0
    if "queue_capacity" in cfg_kw:
        assert ps.stats.rejected > 0


def test_single_lane_scheduler_is_the_one_lane_replica_scheduler():
    eng = _Engine()
    sched = port_sched.Scheduler(eng, port_sched.SchedulerConfig(max_batch=4))
    assert isinstance(sched, port_sched.ReplicaScheduler) and sched.engine is eng
    assert sched.engines == [eng]
    with pytest.raises(ValueError, match="at least one engine"):
        port_sched.ReplicaScheduler([])


# ------------------------------------------------------- replica groups
@pytest.fixture(scope="module")
def stacks():
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    big_cfg, small_cfg, ecfg, _ = model_configs("serve-tiny", VOCAB)
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name)
                                   for f in dataclasses.fields(cls)})
    gen_cfg = GenerateConfig(max_new_tokens=16, sampler=SamplerConfig(vocab_size=VOCAB))
    big, small = (Generator(build_model(c),
                            jax_params_to_torch(_flatten(jstack[k].params), c, device="cpu"),
                            gen_cfg) for k, c in (("big", big_cfg), ("small", small_cfg)))
    pstack = dict(tokenizer=HashWordTokenizer(VOCAB),
                  embedder_params=jax_params_to_torch(_flatten(jstack["embedder_params"]),
                                                      ecfg, device="cpu"),
                  embedder_cfg=ecfg, big=big, small=small,
                  cache_cfg=pick(CacheConfig, jstack["cache_cfg"]),
                  router_cfg=pick(RouterConfig, jstack["router_cfg"]))
    return jstack, pstack


def _trace():
    """Arrivals of repeats, one-word edits and fresh queries, with pairs to
    populate the bank first."""
    g = QuestionPairGenerator(seed=4)
    cached = [g._random_query() for _ in range(6)]
    fresh = [g._random_query().text for _ in range(8)]
    pairs = ([q.text for q in cached],
             [synthesize_response(q.text, q.topic, q.intent) for q in cached])
    texts = ([cached[i].text for i in range(3)] + [cached[i].text + " please" for i in (1, 2, 4, 5)]
             + fresh + fresh[:4] + [cached[5].text, fresh[2]])
    return pairs, jax_sched.poisson_trace(texts, 120.0, seed=5)


def _serve(mod, group, pairs, trace):
    group.engines[0].populate(*pairs)
    sched = mod.ReplicaScheduler(group.engines, mod.SchedulerConfig(max_batch=4, max_wait=0.02,
                                                                    max_new_tokens=MNT),
                                 clock=mod.SimClock(), service_model=lambda b: 0.01 * b)
    done = sorted(mod.replay_trace(sched, trace), key=lambda r: r.rid)
    return sched, done


def _assert_bank_equal(pstate, jstate):
    for key in ("valid", "ptr", "size", "clock", "last_used", "hits", "q_tokens", "r_tokens"):
        assert np.array_equal(pstate[key].numpy(), np.asarray(jstate[key])), key
    np.testing.assert_allclose(pstate["emb"].numpy(), np.asarray(jstate["emb"]), atol=1e-5)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "private"])
def test_replica_group_matches_jax(stacks, shared):
    jstack, pstack = stacks
    pairs, trace = _trace()
    jgroup = JaxReplicaGroup.build(2, shared=shared, **jstack)
    pgroup = ReplicaGroup.build(2, shared=shared, **pstack)
    jsched, jdone = _serve(jax_sched, jgroup, pairs, trace)
    psched, pdone = _serve(port_sched, pgroup, pairs, trace)
    assert [(r.rid, r.response, r.joined, r.finish) for r in pdone] == [
        (r.rid, r.response, r.joined, r.finish) for r in jdone]
    for p, j in zip(pdone, jdone):
        assert min(abs(j.meta["sim"] - THRESHOLD), abs(j.meta["sim"] - 0.9999)) > 5e-5
        assert p.meta["decision"] == j.meta["decision"]
        assert p.meta["sim"] == pytest.approx(j.meta["sim"], abs=1e-5)
    assert dataclasses.asdict(pgroup.stats) == dataclasses.asdict(jgroup.stats)
    assert [(ln.dispatched, ln.batches, ln.stolen_in) for ln in psched.lanes] == [
        (ln.dispatched, ln.batches, ln.stolen_in) for ln in jsched.lanes]
    assert psched.stats.stolen == jsched.stats.stolen
    assert pgroup.shared == shared and pgroup.leaked_kv_pages() == [0, 0]
    for pe, je in zip(pgroup.engines, jgroup.engines):
        _assert_bank_equal(pe.state, je.state)
        assert pe.bank.text_store == je.bank.text_store
    decisions = {r.meta["decision"] for r in pdone}
    assert {router.MISS, router.EXACT} <= decisions and (router.TWEAK in decisions) == shared
    assert all(pe.stats.total > 0 for pe in pgroup.engines)


def test_sharded_bank_group_serves_the_local_trace(stacks):
    """Two replicas over one bank row-sharded on 2 CPU shards serve the
    trace as the local shared group does: responses, stats, bank."""
    _, pstack = stacks
    pairs, trace = _trace()
    local = ReplicaGroup.build(2, **pstack)
    sharded = ReplicaGroup.build(2, mesh=make_cache_mesh(2, devices=["cpu"] * 2), **pstack)
    assert sharded.bank.sharded and not local.bank.sharded
    _, ldone = _serve(port_sched, local, pairs, trace)
    _, sdone = _serve(port_sched, sharded, pairs, trace)
    assert [(r.response, r.meta["decision"]) for r in sdone] == [
        (r.response, r.meta["decision"]) for r in ldone]
    assert dataclasses.asdict(sharded.stats) == dataclasses.asdict(local.stats)
    got = gather_cache_state(sharded.bank.state, pstack["cache_cfg"])
    for key, val in local.bank.state.items():
        assert np.allclose(got[key].numpy(), val.numpy(), atol=1e-6), key


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "private"])
def test_miss_on_one_replica_is_exact_on_the_other(stacks, shared):
    _, pstack = stacks
    group = ReplicaGroup.build(2, shared=shared, **pstack)
    q = "how do i keep basil alive on a windowsill"
    _, m0 = group[0].handle_batch([q], max_new_tokens=MNT, collect_meta=True)
    _, m1 = group[1].handle_batch([q], max_new_tokens=MNT, collect_meta=True)
    assert m0[0]["decision"] == router.MISS
    assert m1[0]["decision"] == (router.EXACT if shared else router.MISS)
    if not shared:
        with pytest.raises(ValueError, match="private"):
            group.bank
    assert [e.replica_id for e in group.engines] == [0, 1]


def test_group_guards_and_stats_aggregate(stacks):
    _, pstack = stacks
    group = ReplicaGroup.build(2, **pstack)
    with pytest.raises(ValueError, match="disagrees"):
        TweakLLMEngine(**dict(pstack, cache_cfg=dataclasses.replace(
            pstack["cache_cfg"], topk=2)), bank=group.bank)
    with pytest.raises(ValueError, match="at least one"):
        ReplicaGroup([])
    a, b = EngineStats(total=2, miss=1, big_tokens=5), EngineStats(total=3, exact=3)
    agg = EngineStats.aggregate([a, b])
    assert (agg.total, agg.miss, agg.exact, agg.big_tokens) == (5, 1, 3, 5)
    with pytest.raises(ValueError, match="cost rates"):
        EngineStats.aggregate([a, EngineStats(big_cost_per_token=10.0)])
    # per-replica generator handles through callables
    calls = []
    made = ReplicaGroup.build(3, **dict(pstack, big=lambda rid: calls.append(rid) or
                                        pstack["big"]))
    assert calls == [0, 1, 2] and len(made) == 3 and made.shared
