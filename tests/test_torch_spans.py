"""The span recorder (``serving/spans.py``) and its sites in the scheduler,
the engine and the generator: spans nest, carry their dispatch, count what
each stage did from host values, and add no host sync; with the recorder
off (the default) nothing is recorded and the outputs are the same."""
import numpy as np
import pytest

from repro_torch.analysis import contracts
from repro_torch.core.engine import BatchResult
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, SimClock
from repro_torch.serving.spans import SpanRecorder
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)


def _within(child, parent):
    return parent.start <= child.start <= child.end <= parent.end


class _Scripted(SpanRecorder):
    """A recorder on a clock the test sets: ``rec.at(t).open(name)``."""

    def __init__(self):
        self.t = 0.0
        super().__init__(lambda: self.t)

    def at(self, t):
        self.t = t
        return self


# ------------------------------------------------------------- recorder

def test_spans_nest_under_the_innermost_open_span_and_carry_their_dispatch():
    rec = _Scripted()
    rec.at(0.0).open("outside")
    rec.at(1.0).close("outside")
    d = rec.at(2.0).open("dispatch")
    a = rec.at(2.1).open("route")
    rec.at(2.2).close("route", rows=np.int64(4))
    b = rec.tagged("small").open("prefill")
    rec.at(2.4).close("prefill")
    rec.at(3.0).close("dispatch", rows=8)
    assert [s.parent for s in rec.spans] == [None, None, d.sid, d.sid]
    assert [s.dispatch for s in rec.spans] == [None, d.sid, d.sid, d.sid]
    assert [s.lm for s in rec.spans] == [None, None, None, "small"]
    assert b.start == 2.2 and b.end == 2.4
    assert a.counts == {"rows": 4} and type(a.counts["rows"]) is int
    assert d.counts == {"rows": 8} and d.seconds == pytest.approx(1.0)
    assert _within(a, d) and _within(b, d)


def test_closing_a_span_ends_the_spans_left_open_inside_it():
    """An exception between a child's sites leaves it open: its parent's
    close ends it at the same time, and a later span nests correctly."""
    rec = _Scripted()
    rec.at(0.0).open("dispatch")
    rec.at(0.1).open("tweak_prompt")
    rec.at(0.5).close("dispatch")
    assert [s.end for s in rec.spans] == [0.5, 0.5]
    nxt = rec.at(1.0).open("dispatch")
    assert nxt.parent is None and nxt.dispatch == nxt.sid
    with pytest.raises(ValueError, match="no open span 'decode'"):
        rec.close("decode")


# ------------------------------------------------------------- generator

def _gen(mnt=8, spec_k=1, recorder=True):
    gen = contracts._tiny_generator("cpu", mnt=mnt, spec_k=spec_k)
    if recorder:
        gen.recorder = SpanRecorder()
    return gen


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mnt", [2, 5, 8])
def test_a_generate_call_records_prefill_decode_and_fetch(mnt, fused):
    gen, plain = _gen(mnt), _gen(mnt, recorder=False)
    toks = contracts._tokens(4, 8, 1)
    real = [8, 5, 3]                      # the fourth row is batch padding
    out = gen.generate_with_lengths({"tokens": toks}, seed=3, fused=fused, real_lens=real)
    want = plain.generate_with_lengths({"tokens": toks}, seed=3, fused=fused)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)
    spans = gen.recorder.spans
    assert [s.name for s in spans] == ["prefill", "decode", "fetch"]
    pre, dec, fetch = spans
    assert pre.counts == {"computed": 32, "needed": 16}
    steps = mnt - 1 if fused else dec.counts["steps"]
    assert dec.counts == {"rows": 4, "steps": steps, "budget": mnt}
    assert fetch.counts == {"tokens": int(out[1][:3].sum())}
    assert pre.end <= dec.start and dec.end <= fetch.start
    assert all(s.parent is None and s.dispatch is None and s.lm is None for s in spans)


def test_a_prefix_call_counts_only_the_suffix_positions():
    gen = _gen(4)
    pc = gen.build_prefix_cache((5, 6, 7, 8), batch=2)
    gen.generate_with_lengths({"tokens": contracts._tokens(2, 16, 2)}, prefix_cache=pc,
                              seed=1, real_lens=[16, 9])
    assert gen.recorder.spans[0].counts == {"computed": 32, "needed": 25}


@pytest.mark.parametrize("overlap", [8, 4])
def test_a_speculative_call_counts_both_phases_as_decode_steps(overlap):
    gen, plain = _gen(8, spec_k=2), _gen(8, recorder=False)
    prompt = contracts._tokens(2, 8, 2)
    ref = plain.generate_with_lengths({"tokens": prompt}, seed=0)[0]
    drafts = (ref[:, :overlap], np.full((2,), overlap, np.int32))
    out, lengths, _ = gen.generate_with_lengths({"tokens": prompt}, seed=0, drafts=drafts)
    np.testing.assert_array_equal(out, ref)
    pre, dec, fetch = gen.recorder.spans
    assert dec.counts["budget"] == 8 and dec.counts["rows"] == 2
    assert dec.counts["steps"] >= gen.last_spec_stats["spec_steps"] >= 1
    assert fetch.counts == {"tokens": int(lengths.sum())}


# ------------------------------------------------------------- no syncs

@pytest.mark.parametrize("name", ["fused_decode", "spec_decode", "prefix_suffix_prefill",
                                  "engine"])
def test_the_sync_contracts_hold_with_the_recorder_on(monkeypatch, name):
    """The contracts' exact sync counts, with a recorder on every generator
    and engine they build: the span sites read host values only."""
    recs = []

    def on(obj):
        obj.recorder = SpanRecorder()
        recs.append(obj.recorder)
        return obj

    tiny, engine = contracts._tiny_generator, contracts._engine
    monkeypatch.setattr(contracts, "_tiny_generator", lambda *a, **k: on(tiny(*a, **k)))

    def recorded_engine(*a, **k):
        return on(engine(*a, **k))

    monkeypatch.setattr(contracts, "_engine", recorded_engine)
    kw = {} if name in ("prefix_suffix_prefill", "engine") else {"buckets": (2,)}
    assert dict(contracts.CONTRACTS)[name]("cpu", **kw) == []
    assert recs and any(r.spans for r in recs)


# ------------------------------------------------------------- engine

def test_the_engine_hands_its_recorder_to_both_generators_tagged():
    """One attachment to the engine records its stages and both models'
    generate calls, each call's spans tagged with its model; None takes
    it off all three."""
    eng = contracts._engine("cpu")
    eng.recorder = rec = SpanRecorder()
    views = [eng.small.recorder, eng.big.recorder]
    assert [(v.lm, v.spans) for v in views] == [("small", rec.spans), ("big", rec.spans)]
    res = eng.handle_batch_result(list(contracts.ENGINE_EDITS + contracts.ENGINE_FRESH),
                                  max_new_tokens=8)
    gen = [s for s in rec.spans if s.name in ("prefill", "decode", "fetch")]
    assert {s.lm for s in gen} == {"small", "big"} and res.small_tokens and res.big_tokens
    assert all(s.lm is None for s in rec.spans if s not in gen)
    fetched = {lm: sum(s.counts["tokens"] for s in gen if s.name == "fetch" and s.lm == lm)
               for lm in ("small", "big")}
    assert fetched == {"small": res.small_tokens, "big": res.big_tokens}
    eng.recorder = None
    assert eng.recorder is eng.small.recorder is eng.big.recorder is None


# ------------------------------------------------------------- scheduler

class _Echo:
    """An engine stand-in: one response a text."""

    def __init__(self):
        self.calls = 0

    def handle_batch_result(self, texts, max_new_tokens=32, **kw):
        self.calls += 1
        return BatchResult([t.upper() for t in texts], [{} for _ in texts])


@pytest.mark.parametrize("on", [False, True])
def test_the_scheduler_links_each_request_to_its_dispatch(on):
    """On the scheduler's clock, the last dispatch span to end at or
    before a request's ``finish`` is the one that served it (the rule by
    which a reader maps completions to dispatches)."""
    clock = SimClock(10.0)
    sched = Scheduler(_Echo(), SchedulerConfig(max_batch=4, max_wait=0.5), clock=clock)
    rec = SpanRecorder(clock.now)
    if on:
        sched.recorder = rec
    reqs = [sched.submit(t) for t in ("a", "b", "c", "d", "e", "a")]
    sched.poll()
    clock.advance(1.0)
    sched.poll()
    assert [r.response for r in reqs] == ["A", "B", "C", "D", "E", "A"]
    if not on:
        assert sched.recorder is None and rec.spans == []
        return
    d0, d1 = rec.spans
    assert (d0.name, d0.counts, d0.start, d0.dispatch) == ("dispatch", {"rows": 4}, 10.0, 0)
    assert (d1.counts, d1.start, d1.dispatch) == ({"rows": 1}, 11.0, 1)
    ends = np.array([d0.end, d1.end])
    served = [int(np.searchsorted(ends, r.finish, side="right")) - 1 for r in reqs]
    assert served == [0, 0, 0, 0, 1, 0]


class _Staged(_Echo):
    """An engine stand-in with a recorder: one ``embed`` span a batch."""
    recorder = None

    def handle_batch_result(self, texts, **kw):
        self.recorder.open("embed")
        self.recorder.close("embed")
        return super().handle_batch_result(texts, **kw)


def test_engine_spans_nest_inside_a_dispatch_on_a_simulated_clock():
    """A scheduler on a ``SimClock`` and its engine share a recorder on
    that clock: each child span lies within its dispatch in time."""
    clock = SimClock(5.0)
    eng = _Staged()
    sched = Scheduler(eng, SchedulerConfig(max_batch=2), clock=clock)
    sched.recorder = eng.recorder = rec = SpanRecorder(clock.now)
    for t in ("a", "b", "c"):
        sched.submit(t)
    sched.flush()
    roots = [s for s in rec.spans if s.name == "dispatch"]
    kids = [s for s in rec.spans if s.name == "embed"]
    assert len(roots) == len(kids) == 2
    for k in kids:
        assert _within(k, rec.spans[k.parent]) and k.dispatch == k.parent


def test_a_dispatch_that_raises_is_closed_and_the_next_nests_afresh():
    class Boom(_Echo):
        def handle_batch_result(self, texts, **kw):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            return super().handle_batch_result(texts, **kw)

    sched = Scheduler(Boom(), SchedulerConfig(max_batch=2), clock=SimClock())
    sched.recorder = rec = SpanRecorder()
    sched.submit("a")
    sched.submit("b")
    with pytest.raises(RuntimeError):
        sched.poll()
    assert sched.pending == 2 and rec.spans[0].end is not None
    sched.poll()
    assert [s.parent for s in rec.spans] == [None, None]
    assert rec.spans[1].dispatch == 1
