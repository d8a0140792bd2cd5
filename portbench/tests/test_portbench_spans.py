"""The program's spans under the harness at a CPU size (``tiny.py``), the
join of a device trace to them (``launch_join.py``) on synthetic events,
and each reading of ``span_readers.py`` on a hand-built context."""
from __future__ import annotations

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness, launch_join, span_readers, stack as stack_lib
from portbench.tests import tiny
from repro_torch.serving.spans import SpanRecorder

SEED = 2 ** 31 + 4242
GEN = ("prefill", "decode", "fetch")


def _attach(st, rec):
    st.sched.recorder = st.engine.recorder = rec


class _Scripted(SpanRecorder):
    """A recorder on a clock the test sets: ``rec.at(t).open(name)``."""

    def __init__(self):
        self.t = 0.0
        super().__init__(lambda: self.t)

    def at(self, t):
        self.t = t
        return self


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One recorded run of each tiny mix: (stack, recorder, EngineStats
    when the recorder went on)."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    out = {}
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(2)
    # another thread of this process (the test runner's) holds the
    # interpreter at most 0.1 ms between two clock readings of a dispatch,
    # not the default 5 ms
    sys.setswitchinterval(1e-4)
    try:
        for mix in ("tiny-closed", "tiny-open"):
            seen = {}

            def on(st):
                seen["rec"] = SpanRecorder()
                _attach(st, seen["rec"])
                seen.update(st=st, eng=st.engine, stats=stack_lib.stats_copy(st.engine.stats))

            result, err, _ = harness.run(root, f"tiny.{mix}", SEED, 2.0, False, device="cpu",
                                         fault=on)
            assert result["correct"], err
            out[mix] = seen
    finally:
        torch.set_num_threads(threads)
        sys.setswitchinterval(interval)
    return out


MIXES = ["tiny-closed", "tiny-open"]


@pytest.mark.parametrize("mix", MIXES)
def test_spans_nest_within_their_parents_and_carry_their_dispatch(runs, mix):
    spans = runs[mix]["rec"].spans
    by_id = {s.sid: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert roots and all(s.name == "dispatch" and s.dispatch == s.sid for s in roots)
    for s in spans:
        assert s.end is not None and s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end and p.sid < s.sid
            assert s.dispatch == p.dispatch
    names = {s.name for s in spans}
    assert {"embed", "route", "exact", "tweak_prompt", *GEN} <= names
    if mix == "tiny-open":
        assert {"miss_prompt", "insert"} <= names
    assert all((s.lm in ("small", "big")) == (s.name in GEN) for s in spans)


@pytest.mark.parametrize("lm", ["small", "big"])
@pytest.mark.parametrize("mix", MIXES)
def test_generate_calls_read_from_the_program_spans_alone_are_the_harness_calls(runs, mix,
                                                                               lm):
    """Each dispatch's ``lm`` calls, grouped from the tagged spans alone,
    are the calls the harness's wrapper recorded: as many, each with its
    rows and padded width."""
    log, spans = runs[mix]["st"].log, runs[mix]["rec"].spans
    roots = [s for s in spans if s.name == "dispatch"]
    recorded = [d for d in log.dispatches if d["start"] >= roots[0].start]
    ctx = types.SimpleNamespace(spans=spans)
    seen = 0
    for d, r in zip(recorded, roots):
        calls = span_readers._calls(ctx, [r], lm)
        assert len(calls) == len(d[lm])
        for c, h in zip(calls, d[lm]):
            rows, width = np.asarray(h["tokens"]).shape
            assert set(c) == set(GEN) and c["decode"].counts["rows"] == rows
            assert c["prefill"].counts["computed"] == rows * width
            assert h["start"] <= c["prefill"].start and c["fetch"].end <= h["end"]
        seen += len(calls)
    assert seen or (mix, lm) == ("tiny-closed", "big")


@pytest.mark.parametrize("mix", MIXES)
def test_the_program_dispatch_spans_agree_with_the_harness_within_a_ms(runs, mix):
    log, spans = runs[mix]["st"].log, runs[mix]["rec"].spans
    roots = [s for s in spans if s.name == "dispatch"]
    recorded = [d for d in log.dispatches if d["start"] >= roots[0].start]
    assert len(recorded) == len(roots) > 3
    for d, r in zip(recorded, roots):
        assert abs(d["start"] - r.start) < 1e-3 and abs(d["end"] - r.end) < 1e-3
        assert r.counts["rows"] == len(d["texts"])


@pytest.mark.parametrize("mix", MIXES)
def test_each_fused_decode_runs_the_budget_less_one_step(runs, mix):
    budget = tiny.SERVING["max_new_tokens"]
    dec = [s for s in runs[mix]["rec"].spans if s.name == "decode"]
    assert dec and all(s.counts["steps"] == budget - 1 and s.counts["budget"] == budget
                       for s in dec)


@pytest.mark.parametrize("mix", MIXES)
def test_fetched_tokens_sum_to_the_engine_stats_token_deltas(runs, mix):
    r = runs[mix]
    fetched = sum(s.counts["tokens"] for s in r["rec"].spans if s.name == "fetch")
    now, then = r["eng"].stats, r["stats"]
    assert fetched == (now.small_tokens + now.big_tokens
                       - then.small_tokens - then.big_tokens) > 0


@pytest.mark.parametrize("mix", MIXES)
def test_tweak_calls_count_the_small_generate_calls_one_a_suffix_bucket(runs, mix):
    log, spans = runs[mix]["st"].log, runs[mix]["rec"].spans
    prompts = [s for s in spans if s.name == "tweak_prompt"]
    roots = [s for s in spans if s.name == "dispatch"]
    recorded = [d for d in log.dispatches if d["start"] >= roots[0].start]
    calls = {s.dispatch: s.counts["calls"] for s in prompts}
    assert prompts
    for d, r in zip(recorded, roots):
        widths = {np.asarray(c["tokens"]).shape[1] for c in d["small"]}
        assert calls.get(r.sid, 0) == len(d["small"]) == len(widths)


def test_tweak_rows_of_two_suffix_buckets_make_two_generate_calls():
    st = stack_lib.build(dict(tiny.BIG, small=tiny.SMALL, embedder=tiny.EMB,
                              serving=tiny.SERVING), 7, "cpu")
    short = ["how do i reset my router password", "what is the capital of france"]
    long_ = [("explain in detail how the quarterly budget review works for the regional "
              "offices and what each manager should prepare ") * 3,
             ("describe the history of the mediterranean trade routes and the empires "
              "that held the ports over centuries of conflict ") * 3]
    st.engine.populate(short + long_, ["a short answer", "another short answer"]
                       + ["a long answer of many words " * 8] * 2)
    rec = SpanRecorder()
    _attach(st, rec)
    res = st.engine.handle_batch_result(["please " + q for q in short + long_],
                                        max_new_tokens=8)
    assert [m["decision"] for m in res.meta] == [1, 1, 1, 1]          # all TWEAK
    (prompt,) = [s for s in rec.spans if s.name == "tweak_prompt"]
    pre = [s for s in rec.spans if s.name == "prefill"]
    dec = [s for s in rec.spans if s.name == "decode"]
    assert prompt.counts == {"calls": 2} and len(pre) == 2
    assert len({p.counts["computed"] // d.counts["rows"] for p, d in zip(pre, dec)}) == 2
    assert all(s.parent is None for s in rec.spans)                     # no scheduler here


def test_the_recorder_off_leaves_responses_and_stats_as_they_are():
    """Two stacks from one seed serve the same texts, one recorded: the
    same responses and EngineStats; the unrecorded one records nothing."""
    cfg = dict(tiny.BIG, small=tiny.SMALL, embedder=tiny.EMB, serving=tiny.SERVING)
    from portbench.traffic import Traffic
    traffic = Traffic(tiny.TRAFFIC["tiny-open"], SEED, 2.0)
    texts = traffic.stream[:40]
    out = []
    for on in (False, True):
        st = stack_lib.build(cfg, SEED, "cpu")
        rec = SpanRecorder() if on else None
        if on:
            _attach(st, rec)
        reqs = [st.sched.submit(t) for t in texts]
        st.sched.flush()
        assert st.sched.recorder is st.engine.recorder is rec
        views = [g.recorder for g in (st.engine.small, st.engine.big)]
        if on:
            assert [(v.lm, v.spans) for v in views] == [("small", rec.spans), ("big", rec.spans)]
        else:
            assert views == [None, None]
        out.append(([r.response for r in reqs], dataclasses.asdict(st.engine.stats)))
    (resp0, stats0), (resp1, stats1) = out
    assert resp0 == resp1 and stats0 == stats1 and stats0["miss"] > 0
    assert {s.lm for s in rec.spans} == {None, "small", "big"}


# ------------------------------------------------------------- the join

def _events():
    """Kineto-like records (ns): the opening marker at device 5,000,000 ns
    (launched at 4,990,000), three kernels, a copy, the closing marker."""
    kernels = [("spin_kernel", 4_000_000, 4_500_000, 1),           # a sentinel
               ("spin_kernel", 5_000_000, 5_001_000, 2),           # the opening marker
               ("gemm", 5_100_000, 5_200_000, 3),
               ("elementwise", 5_300_000, 5_310_000, 4),
               ("Memcpy DtoH", 5_400_000, 5_420_000, 5),
               ("spin_kernel", 6_000_000, 6_001_000, 6)]
    launches = {2: 4_990_000, 3: 5_050_000, 4: 5_060_000, 6: 5_990_000}
    return kernels, launches


class _Event:
    def __init__(self, name, cuda, start, dur, corr):
        self._v = (name, cuda, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_events_reads_the_cards_records_and_the_launches_of_each():
    """Every record on the card is a kernel (copies too, as ``trace.py``
    counts them); of the host's, only the launch, copy and set calls."""
    evs = [_Event("gemm", True, 100, 50, 7), _Event("Memcpy DtoH", True, 200, 10, 8),
           _Event("cudaLaunchKernel", False, 90, 3, 7),
           _Event("cudaMemcpyAsync", False, 190, 30, 8),
           _Event("cuLaunchKernelEx", False, 300, 2, 9),
           _Event("cudaStreamSynchronize", False, 400, 5, 10)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    kernels, launches = launch_join.events(prof)
    assert kernels == [("gemm", 100, 150, 7), ("Memcpy DtoH", 200, 210, 8)]
    assert launches == {7: 90, 8: 190, 9: 300}


def test_join_maps_kernels_and_launches_onto_the_host_clock():
    kernels, launches = _events()
    j = launch_join.join(kernels, launches, 100.0, 101.0)
    got = {k[0]: k[1:] for k in j["kernels"]}
    assert set(got) == {"gemm", "elementwise", "Memcpy DtoH"}
    # device times by the marker's device start (t0 = 100 at 5.000 ms)
    assert got["gemm"][0] == pytest.approx(100.0001) and got["gemm"][1] == pytest.approx(100.0002)
    # launch times by the marker's launch record (t0 = 100 at 4.990 ms)
    assert got["gemm"][2] == pytest.approx(100.00006)
    assert got["elementwise"][2] == pytest.approx(100.00007)
    assert got["Memcpy DtoH"][2] == got["Memcpy DtoH"][0]          # no record: its start
    assert (j["matched"], j["unmatched"], j["method"]) == (2, 1, "launch")
    assert j["launch_lag_s"] == pytest.approx(1e-5)


def test_join_falls_back_to_device_starts_without_launch_records():
    kernels, _ = _events()
    j = launch_join.join(kernels, {}, 100.0, 101.0)
    assert (j["matched"], j["unmatched"], j["method"]) == (0, 3, "device_start")
    assert all(k[3] == k[1] for k in j["kernels"]) and j["launch_lag_s"] == 0


def _program(intervals):
    rec = _Scripted()
    for name, t, opening in intervals:
        rec.at(t).open(name) if opening else rec.at(t).close(name)
    return rec.spans


def test_innermost_finds_the_deepest_open_span():
    spans = [("a", 0.0, 10.0), ("b", 1.0, 5.0), ("c", 2.0, 3.0), ("d", 5.0, 5.0),
             ("e", 6.0, 10.0)]
    got = launch_join.innermost(spans, [-1, 0.5, 1.5, 2.5, 3.5, 5.0, 5.5, 7, 10, 11])
    assert list(got) == [-1, 0, 1, 2, 1, 0, 0, 4, -1, -1]
    assert list(launch_join.innermost([], [1.0])) == [-1]


def test_idle_gaps_carry_harness_and_program_labels():
    harness_spans = [("dispatch", 1.0, 9.0, 0), ("lookup", 2.0, 3.0, 0),
                     ("small_gen", 4.0, 8.0, 0)]
    prog = _program([("dispatch", 0.99, True), ("embed", 1.1, True), ("embed", 1.9, False),
                     ("route", 2.0, True), ("route", 2.9, False),
                     ("prefill", 4.1, True), ("prefill", 5.0, False),
                     ("decode", 5.0, True), ("decode", 7.0, False),
                     ("fetch", 7.0, True), ("fetch", 7.9, False),
                     ("dispatch", 9.01, False)])
    gaps = [(0.2, 0.4), (1.2, 1.4), (2.2, 2.4), (3.2, 3.4), (4.02, 4.06), (4.4, 4.6),
            (6.0, 6.4), (7.4, 7.6), (7.95, 7.97)]
    got = launch_join.attribute(gaps, harness_spans, prog)
    want = {"harness": 0.2, "dispatch/embed": 0.2, "lookup/route": 0.2, "dispatch": 0.2,
            "small_gen": 0.04 + 0.02, "small_gen/prefill": 0.2, "small_gen/decode": 0.4,
            "small_gen/fetch": 0.2}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())
    assert launch_join.attribute([], harness_spans, prog) == {}


# ------------------------------------------------------------- readers

def _dispatch(rec, t, prompt_calls, small, big):
    """A harness record and its program spans at offset ``t``: a small
    call (decode ``small`` s, fetch half of it) and a big one."""
    d = {"start": t + 1.0, "end": t + 3.0, "texts": ["q"] * 6}
    rec.at(t + 0.999).open("dispatch")
    rec.at(t + 1.1).open("tweak_prompt")
    rec.at(t + 1.15).close("tweak_prompt", calls=prompt_calls)
    for lm, c0, dec, counts in (("small", 1.2, small, (4, 400, 100, 24)),
                                ("big", 2.1, big, (2, 64, 48, 16))):
        rows, computed, needed, tokens = counts
        a = t + c0
        gen = rec.at(a + 0.01).tagged(lm)
        gen.open("prefill")
        rec.at(a + 0.1)
        gen.close("prefill", computed=computed, needed=needed)
        gen.open("decode")
        rec.at(a + 0.1 + dec)
        gen.close("decode", rows=rows, steps=7, budget=8)
        gen.open("fetch")
        rec.at(a + 0.1 + 1.5 * dec)
        gen.close("fetch", tokens=tokens)
    rec.at(t + 3.001).close("dispatch")
    return d


def _ctx(trace=True):
    rec = _Scripted()
    d1 = _dispatch(rec, 0.0, 1, 0.5, 0.5)           # inside the profiled part [0, 10]
    d2 = _dispatch(rec, 10.0, 2, 0.2, 0.28)         # after it
    kernels = [("k_prefill_small", 1.26, 1.28, 1.25), ("k_dec_a", 1.36, 1.40, 1.35),
               ("k_dec_b", 1.50, 1.60, 1.40), ("k_prefill_big", 2.16, 2.19, 2.15),
               ("k_dec_big", 2.30, 2.50, 2.30), ("k_outside", 0.50, 0.60, 0.50)]
    ctx = types.SimpleNamespace(dispatches=[d1, d2], all_dispatches=[d1, d2],
                                spans=rec.spans, trace=None)
    if trace:
        ctx.trace = {"t0": 0.0, "t1": 10.0, "launch_join": {"kernels": kernels}}
    return ctx


EXPECTED = {
    "tweak_calls.closed": 1.5,                                   # 1 and 2 calls
    "tweak_step_ms.closed": 1e3 * 0.3 / 7,                       # after the trace only
    "tweak_step_launches.closed": 2 / 7,                         # two launches in decode
    "miss_step_ms.closed": 1e3 * 0.42 / 7,
    "miss_step_ms.open": 1e3 * 0.42 / 7,
    "miss_step_launches.closed": 1 / 7,
    "miss_step_launches.open": 1 / 7,
    "prefill_real_share.closed": 100.0 * 148 / 464,
    "decode_real_share.closed": 100.0 * 40 / 48,
    "decode_real_share.open": 100.0 * 40 / 48,
    "prefill_device_ms.closed": 1e3 * (0.02 + 0.03),             # one traced dispatch
    "decode_idle.closed": 100.0 * (1 - (0.04 + 0.10 + 0.20) / 1.5),
    "decode_idle.open": 100.0 * (1 - (0.04 + 0.10 + 0.20) / 1.5),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reading_on_a_hand_built_context(name):
    assert span_readers.READERS[name](_ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reading_without_a_trace_or_spans(name):
    """Untraced: the device readings have nothing to read; the host
    readings take every dispatch.  No spans: nothing to read at all."""
    untraced = span_readers.READERS[name](_ctx(trace=False))
    src = name.split(".")[0]
    if src in ("tweak_step_launches", "miss_step_launches", "prefill_device_ms",
               "decode_idle"):
        assert untraced is None
    elif src in ("tweak_step_ms", "miss_step_ms"):
        both = 0.5 * 1.5 + 0.2 * 1.5 if src == "tweak_step_ms" else 0.5 * 1.5 + 0.28 * 1.5
        assert untraced == pytest.approx(1e3 * both / 14)
    else:
        assert untraced == pytest.approx(EXPECTED[name])
    empty = _ctx()
    empty.spans = []
    assert span_readers.READERS[name](empty) is None
