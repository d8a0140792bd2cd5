"""The harness's arithmetic on hand-made inputs: rates and percentiles over
spans, the yardstick's operations and bytes against hand arithmetic, the
traffic's determinism, the trace's busy time and idle attribution."""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, trace, traffic, yardstick as ys
from portbench.tests import tiny


def _dispatch(start, end, n):
    return {"start": start, "end": end, "texts": ["q"] * n}


def _closed(stall=0.0):
    """10 dispatches of 32 rows, 1 s each, back to back from t=0; a stall of
    ``stall`` seconds before the 5th; the window [0, 12)."""
    ran, reqs, t = [], [], 0.0
    for i in range(10):
        if i == 4:
            t += stall
        ran.append(_dispatch(t, t + 1.0, 32))
        reqs += [SimpleNamespace(arrival=t, finish=t + 1.0 + 1e-6) for _ in range(32)]
        t += 1.0
    return ran, reqs


def test_closed_rate_counts_whole_dispatches_and_a_stall_lowers_it():
    ran, reqs = _closed()
    m = harness.closed_metrics(ran, reqs, 0.0, 12.0)
    assert m["req_per_s"] == pytest.approx(320 / 10.0)
    assert m["attempted"] == 320 and m["failed"] == 0
    # a dispatch that ends after the window closes is not counted
    m = harness.closed_metrics(ran, reqs, 0.0, 9.5)
    assert m["req_per_s"] == pytest.approx(9 * 32 / 9.0)
    ran, reqs = _closed(stall=2.0)
    assert harness.closed_metrics(ran, reqs, 0.0, 13.0)["req_per_s"] == pytest.approx(320 / 12)


def _open(stall=0.0, n=200, rate=10.0):
    """Requests due every 1/rate s, each served alone in 50 ms; a stall of
    ``stall`` s at t = 5 holds up every request due during it."""
    ran, reqs, free = [], [], 0.0
    for i in range(n):
        due = i / rate
        start = max(due, free)
        if stall and 5.0 <= due < 5.0 + stall:
            start = max(start, 5.0 + stall)
        ran.append(_dispatch(start, start + 0.05, 1))
        free = start + 0.05
        reqs.append((due, SimpleNamespace(arrival=due, finish=start + 0.05)))
    return ran, reqs


queue_wait = harness.reader(tiny.ROOT, "queue_wait_p95_ms.open")


def test_open_latency_runs_from_the_due_time_and_a_stall_raises_the_tail():
    ran, reqs = _open()
    m, rows = harness.open_metrics(ran, reqs)
    assert m["lat_p50_ms"] == pytest.approx(50.0) and m["lat_p95_ms"] == pytest.approx(50.0)
    ctx = SimpleNamespace(requests=rows)
    assert queue_wait(ctx) == pytest.approx(0.0, abs=1e-9)
    ran, reqs = _open(stall=2.0)
    m2, rows = harness.open_metrics(ran, reqs)
    assert m2["lat_p95_ms"] > 1000.0 and m2["lat_p50_ms"] == pytest.approx(50.0)
    assert queue_wait(SimpleNamespace(requests=rows)) > 900.0
    # a shed request counts as missing every limit
    reqs[0] = (reqs[0][0], None)
    m3, _ = harness.open_metrics(ran, reqs)
    assert np.isfinite(m3["lat_p95_ms"])
    reqs[:20] = [(d, None) for d, _ in reqs[:20]]
    assert harness.open_metrics(ran, reqs)[0]["lat_p95_ms"] == float("inf")


@pytest.mark.parametrize("name", ["qwen2.5-3b_nemotron-4-340b", "danube-1.8b_qwen3-moe-235b"])
def test_operations_and_bytes_equal_hand_arithmetic_for_one_layer(name):
    cfg = json.loads((tiny.ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    for c in (dict(cfg, num_layers=1), dict(cfg["small"], num_layers=1)):
        d, h, k, dh = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
        attn = d * h * dh + 2 * d * k * dh + h * dh * d
        if c.get("num_experts"):
            ffn = 8 * 3 * d * 1536 + d * 128
        elif c["mlp_type"] == "swiglu":
            ffn = 3 * d * c["d_ff"]
        else:
            ffn = 2 * d * c["d_ff"]
        n = attn + ffn + d * c["vocab_size"]
        assert ys.active_params(c) == n
        # one row: prompt of 3, 2 served tokens (one decode step at 4 keys)
        att = lambda keys: 4 * h * dh * keys
        assert ys.row_flops(c, 3, 0, 2) == 4 * 2 * n + att(1) + att(2) + att(3) + att(4)
        assert ys.row_flops(c, 3, 2, 2) == 2 * 2 * n + att(3) + att(4)
        assert ys.decode_kv_bytes(c, 3, 3) == (4 + 5) * 2 * k * dh * 2
    assert ys.scan_bytes(16_384, 384, 32) == 16_384 * 384 * 4 + 32 * 384 * 4


def test_scan_roofline_counts_the_rows_the_bank_held_not_its_slots():
    """Two lookups of 32 queries over a bank of 1,000 and then 1,032 rows,
    1 ms of scan kernel: the least time is those rows' embeddings and the
    queries at 3.35 TB/s, whatever the bank's capacity."""
    read = harness.reader(tiny.ROOT, "cosine_topk_roofline.closed")
    route = lambda held, t: {"bank_rows": held, "rows": 32, "start": t, "end": t + 0.01}
    ctx = SimpleNamespace(
        cfg={"embedder": {"d_model": 384}, "serving": {"bank_rows": 262_144}},
        all_dispatches=[{"route": route(1000, 0.1)}, {"route": route(1032, 0.2)},
                        {"route": route(1064, 9.0)}, {"route": None}],
        trace={"t0": 0.0, "t1": 1.0, "kernels": [("cosine_topk_scan", 0.1, 0.1005),
                                                 ("cosine_topk_merge", 0.2, 0.2005),
                                                 ("other", 0.3, 0.4)]})
    need = (1000 + 32 + 1032 + 32) * 384 * 4
    assert read(ctx) == pytest.approx(100.0 * need / ys.HBM_BYTES_PER_S / 1e-3)
    ctx.trace["kernels"] = [("other", 0.3, 0.4)]
    assert read(ctx) is None


def test_nemotron_layer_and_qwen3_moe_layer_sizes():
    nem = json.loads((tiny.ROOT / "portbench/configs/qwen2.5-3b_nemotron-4-340b.json")
                     .read_text())
    moe = json.loads((tiny.ROOT / "portbench/configs/danube-1.8b_qwen3-moe-235b.json")
                     .read_text())
    one = lambda c: ys.active_params(dict(c, num_layers=1, vocab_size=0))
    assert one(nem) == pytest.approx(3.45e9, rel=0.01)
    # all 128 experts of a layer, against the 8 a token multiplies through
    full = one(moe) + 120 * 3 * 4096 * 1536
    assert full == pytest.approx(2.49e9, rel=0.01)


def test_traffic_is_the_same_for_the_same_seed_and_unique_never_repeats():
    root = tiny.ROOT / "portbench" / "traffic"
    for name in ("lmsys-closed", "unique-closed", "unique-open"):
        spec = dict(json.loads((root / f"{name}.json").read_text()), warm_set=512, stream=2000)
        a, b = traffic.Traffic(spec, 2 ** 31 + 5, 30), traffic.Traffic(spec, 2 ** 31 + 5, 30)
        c = traffic.Traffic(spec, 2 ** 31 + 6, 30)
        assert a.stream == b.stream and a.warm == b.warm and a.stream != c.stream
        if spec["queries"]["kind"] == "unique":
            texts = a.warmup + a.stream
            assert len(set(texts)) == len(texts)
            # every seed serves the same lengths, in another order
            assert sorted(map(len, (t.split() for t in a.stream))) == \
                sorted(map(len, (t.split() for t in c.stream)))
        if a.due is not None:
            assert np.allclose(np.sort(np.diff(a.due, prepend=0)),
                               np.sort(np.diff(c.due, prepend=0)))


def test_busy_time_and_idle_gaps_by_span():
    kernels = [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)]
    busy, gaps = trace._busy(kernels, 0.0, 5.0)
    assert busy == pytest.approx(3.0) and gaps == [(2.0, 3.0), (4.0, 5.0)]
    spans = [("dispatch", 1.5, 4.2, 0), ("big_gen", 2.5, 3.5, 0)]
    idle = trace._attribute(gaps, spans)
    assert idle == {"big_gen": pytest.approx(1.0), "harness": pytest.approx(1.0)}
