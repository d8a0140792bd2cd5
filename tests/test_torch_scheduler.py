"""Port scheduler and serving CLI: barrier and continuous ``SimClock`` replays
give the JAX package's scheduler stats and per-request completions with the
same deterministic engine; the port's engine served through either mode
gives the same responses and ``EngineStats``; the CLI runs on the CPU at
serve-tiny, replicas and a sharded bank included."""
import dataclasses
import inspect

import pytest

from repro.serving import scheduler as jax_sched
from repro_torch.core.router import RouterConfig
from repro_torch.launch import serve
from repro_torch.serving import scheduler as port_sched
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)


@dataclasses.dataclass
class _Result:
    responses: list
    meta: list
    big_tokens: int
    small_tokens: int


class _Engine:
    """Deterministic engine: the response and token counts are functions of
    the text alone."""

    def __init__(self):
        self.calls = []

    def handle_batch_result(self, texts, *, max_new_tokens, cost_thresholds=None):
        self.calls.append((tuple(texts), cost_thresholds))
        meta = [{"decision": len(t) % 3, "sim": 0.5, "gen_tokens": len(t) % max_new_tokens}
                for t in texts]
        return _Result([t.upper() for t in texts], meta,
                       sum(m["gen_tokens"] for m in meta if m["decision"] == 0),
                       sum(m["gen_tokens"] for m in meta if m["decision"] != 0))


def _trace(mod, n=40, rate=150.0, seed=3):
    texts = [f"query {i % 13} about topic {i % 5}" for i in range(n)]
    return mod.poisson_trace(texts, rate, seed=seed)


def _replay(mod, cfg_kw, service):
    eng = _Engine()
    sched = mod.Scheduler(eng, mod.SchedulerConfig(**cfg_kw), clock=mod.SimClock(),
                          service_model=service)
    done = sorted(mod.replay_trace(sched, _trace(mod)), key=lambda r: r.rid)
    return sched, eng, [(r.rid, r.text, r.response, r.joined, r.finish, r.latency, r.meta)
                        for r in done]


@pytest.mark.parametrize("cfg_kw", [
    dict(max_batch=4, max_wait=0.02),
    dict(max_batch=8, max_wait=0.05, dedup=False),
    dict(max_batch=4, queue_capacity=3),                  # sheds under overload
    dict(continuous=True, slots=4),
    dict(continuous=True, slots=2, cost_threshold=0.3),
])
def test_replay_matches_jax(cfg_kw):
    service = lambda n: 0.004 + 0.001 * n
    assert _trace(port_sched) == _trace(jax_sched)
    js, je, jdone = _replay(jax_sched, cfg_kw, service)
    ps, pe, pdone = _replay(port_sched, cfg_kw, service)
    assert dataclasses.asdict(ps.stats) == dataclasses.asdict(js.stats)
    assert pdone == jdone
    assert pe.calls == je.calls
    assert ps.stats.completed + ps.stats.rejected == 40


def test_queue_full_and_deadlines():
    sched = port_sched.Scheduler(_Engine(), port_sched.SchedulerConfig(
        max_batch=4, max_wait=0.05, queue_capacity=2), clock=port_sched.SimClock())
    sched.submit("a")
    sched.submit("b")
    with pytest.raises(port_sched.QueueFull):
        sched.submit("c")
    assert sched.next_wakeup() == pytest.approx(0.05)
    assert sched.poll() == []                              # deadline not reached
    sched.clock.advance(0.05)
    assert [r.response for r in sched.poll()] == ["A", "B"]
    with pytest.raises(ValueError):
        port_sched.SchedulerConfig(max_batch=0)
    with pytest.raises(TypeError):
        port_sched.replay_trace(port_sched.Scheduler(_Engine(), clock=port_sched.WallClock()),
                                [])


def test_engine_continuous_equals_barrier():
    """The port's engine behind both modes: with TWEAK collapsed into EXACT
    (every request a MISS or an exact repeat), responses and EngineStats
    agree, and continuous dispatch waits for no bucket to fill."""
    texts = ["how do i learn rust", "why is keto good", "how do i learn rust",
             "what is solar power", "why is keto good", "how do i fix a bike"] * 2
    trace = [(0.01 * i, t) for i, t in enumerate(texts)]
    out = {}
    for mode in ("barrier", "continuous"):
        eng = serve.build_engine(model="serve-tiny", device="cpu", vocab=2048, capacity=64,
                                 train_embedder_steps=0)
        eng.router_cfg = RouterConfig(tweak_threshold=0.9999)
        eng.bank.router_cfg = eng.router_cfg
        cfg = port_sched.SchedulerConfig(max_batch=4, max_wait=0.02, max_new_tokens=4,
                                         continuous=mode == "continuous", slots=4)
        sched = port_sched.Scheduler(eng, cfg, clock=port_sched.SimClock(),
                                     service_model=lambda n: 0.01)
        done = sorted(port_sched.replay_trace(sched, trace), key=lambda r: r.rid)
        out[mode] = ([r.response for r in done], dataclasses.asdict(eng.stats), sched.stats)
    assert out["barrier"][0] == out["continuous"][0]
    assert out["barrier"][1] == out["continuous"][1]
    assert out["barrier"][1]["exact"] > 0 and out["barrier"][1]["miss"] > 0
    assert out["continuous"][2].batches > out["barrier"][2].batches
    assert out["continuous"][2].mean_latency < out["barrier"][2].mean_latency


def test_cli_runs_on_cpu(capsys):
    assert serve.main(["--queries", "12", "--device", "cpu", "--batch", "4",
                       "--embedder-steps", "0"]) == 0
    report = capsys.readouterr().out
    assert "serving report" in report and "requests: 12" in report
    assert "routing: miss=" in report and "cost:" in report


@pytest.mark.parametrize("flags", [["--index", "ivf"],
                                   ["--index", "ivf", "--admit-floor", "0.9"]])
def test_cli_serves_ivf_on_cpu(flags, capsys):
    assert serve.main(["--queries", "24", "--device", "cpu", "--batch", "4",
                       "--embedder-steps", "0", *flags]) == 0
    report = capsys.readouterr().out
    assert "requests: 24" in report and "routing: miss=" in report
    assert ("suppressed_inserts=" in report) == ("--admit-floor" in flags)


@pytest.mark.parametrize("flags", [["--band", "0.12", "--reranker-steps", "3",
                                    "--embedder-steps", "2"], ["--embedder-steps", "5"]])
def test_cli_runs_cascade_and_embedder_training_on_cpu(flags, capsys):
    assert serve.main(["--queries", "24", "--device", "cpu", "--batch", "4", *flags]) == 0
    report = capsys.readouterr().out
    assert "requests: 24" in report and "routing: miss=" in report
    assert ("cascade: uncertain=" in report) == ("--band" in flags)


def test_cli_defaults_are_the_reference_stack(monkeypatch):
    """The CLI and ``build_stack`` default to the reference's training: 60
    embedder steps, 120 reranker steps (used when --band > 0)."""
    seen = {}

    class Built(Exception):
        pass

    def fake_build(**kw):
        seen.update(kw)
        raise Built

    monkeypatch.setattr(serve, "build_engine", fake_build)
    with pytest.raises(Built):
        serve.main(["--device", "cpu"])
    assert (seen["train_embedder_steps"], seen["train_reranker_steps"], seen["band"]) == (
        60, 120, 0.0)
    sig = inspect.signature(serve.build_stack).parameters
    assert (sig["train_embedder_steps"].default, sig["train_reranker_steps"].default,
            sig["band"].default) == (60, 120, 0.0)


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--cache-shards", "2"],
                                  ["--private-caches"]])
def test_cli_refuses_unported_paths(flag, capsys):
    """The replica and sharding flags, once refused, now serve as the
    reference wires them: ``--replicas 2`` and ``--cache-shards 2`` build a
    replica group (over 2 CPU shards for the latter) behind the replica
    scheduler; ``--private-caches`` alone keeps one engine."""
    assert serve.main(["--device", "cpu", "--queries", "16", "--embedder-steps", "2",
                       *flag]) == 0
    report = capsys.readouterr().out
    assert "requests: 16" in report and "routing: miss=" in report
    assert ("replicas: 2 (shared bank, shards=1) r0:" in report) == (flag[0] == "--replicas")
    assert "replicas:" not in report or "stolen=" in report
