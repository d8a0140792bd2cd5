"""Whole runs at a CPU size (``tiny.py``): the harness skips its look for a
chip and drives the rest, the real program underneath.  A sound run comes
out correct; each fault planted in the timed path, and the control in the
program's place, comes out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.tests import tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run(root, cell, SEED, 2.0, False, device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)


def test_a_run_leaves_the_process_grad_mode_as_it_found_it(root):
    """A run serves under ``no_grad`` and restores the caller's mode: the
    tests that share a worker process train with autograd."""
    assert torch.is_grad_enabled()
    _run(root, "tiny.tiny-open")
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("cell", ["tiny.tiny-closed", "tiny.tiny-open"])
def test_a_sound_run_is_correct_and_reports_its_metrics(root, cell):
    result, err, mods = _run(root, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, err
    want = {"req_per_s", "setup_s"} if "closed" in cell else {"lat_p95_ms", "lat_p50_ms",
                                                              "setup_s"}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checked" and set(result["checked"]) == set(check.NUMBERS)
    assert err[-1].startswith("big_gap") and "limit" in err[-1]


@pytest.mark.parametrize("mix", ["tiny-closed", "tiny-open"])
def test_each_lookup_records_the_rows_the_bank_held(root, mix):
    """The host count of committed rows at each lookup: the warm set, then
    every earlier dispatch's commits (the open mix's MISS rows add some)."""
    seen = {}
    result, err, _ = _run(root, f"tiny.{mix}", fault=lambda st: seen.setdefault("st", st))
    assert result["correct"], err
    held = tiny.TRAFFIC[mix]["warm_set"]
    for d in seen["st"].log.dispatches:
        assert d["route"]["bank_rows"] == held
        held += sum(i["count"] for i in d["inserts"])
    assert held > 0


def _alter_output(kind):
    """A served token altered where the generator produces it."""
    def fault(st):
        gen = getattr(st.engine, kind)._gen
        real = gen.generate_with_lengths

        def altered(batch, **kw):
            out, lengths, ended = real(batch, **kw)
            out = out.copy()
            out[:, 1] = (out[:, 1] + 1) % 500 + 5
            return out, lengths, ended
        gen.generate_with_lengths = altered
    return fault


def _alter_scores(st):
    """The lookup's answer altered: every top-1 score lowered by 0.05."""
    bank = st.engine.bank._bank
    real = bank.route_batch

    def altered(q, cost=None):
        s, idx, dec, tau, cluster, admit = real(q, cost)
        return s - 0.05, idx, dec, tau, cluster, admit
    bank.route_batch = altered


def _half_batch(st):
    """Half of each dispatch served, its answers given to the other half."""
    eng = st.entry.engine

    class Half:
        def __getattr__(self, name):
            return getattr(eng, name)

        def handle_batch_result(self, texts, **kw):
            k = max(1, len(texts) // 2)
            res = eng.handle_batch_result(texts[:k], **kw)
            res.responses = (res.responses * 2)[:len(texts)]
            res.meta = (res.meta * 2)[:len(texts)]
            return res
    st.entry.engine = Half()


@pytest.mark.parametrize("name,fault,cell", [
    ("big token", _alter_output("big"), "tiny.tiny-open"),
    ("small token", _alter_output("small"), "tiny.tiny-closed"),
    ("lookup answer", _alter_scores, "tiny.tiny-closed"),
    ("half the batch", _half_batch, "tiny.tiny-closed"),
])
def test_a_fault_in_the_timed_path_is_not_correct(root, name, fault, cell):
    result, err, _ = _run(root, cell, fault=fault)
    assert not result["correct"], (name, err)


def test_the_control_is_not_correct(root):
    """The reference in fp8 in the program's place fails the gaps that the
    program's own runs meet."""
    sound, _, _ = _run(root, "tiny.tiny-open")
    ctl, err, _ = _run(root, "tiny.tiny-open", control=True)
    assert sound["correct"] and not ctl["correct"], err
    assert ctl["checked"]["big_gap"]["value"] > sound["checked"]["big_gap"]["value"]


def test_the_sample_holds_the_longest_dispatch_and_both_models():
    log = type("L", (), {})()
    calls = lambda n: [{"lengths": np.full(4, n)}]
    log.dispatches = [{"small": calls(2), "big": []}, {"small": [], "big": calls(8)},
                      {"small": calls(1), "big": calls(1)}, {"small": calls(3), "big": []}]
    s = check.choose_sample(log, [0, 1, 2, 3], SEED, per_kind=1)
    assert s[0] == 1 and any(log.dispatches[i]["small"] for i in s)


@pytest.mark.parametrize("serving", [{"paged": True, "spec_k": 4}, {"index": "ivf", "nprobe": 64}])
def test_a_later_cell_with_other_serving_keys_needs_only_data(tmp_path, serving):
    """The paged pool with speculative TWEAK decode, or the clustered index:
    a configuration file alone turns them on, and the check holds them."""
    import json
    root = tiny.make_root(tmp_path)
    path = root / "portbench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["serving"].update(serving)
    path.write_text(json.dumps(cfg))
    result, err, _ = _run(root, "tiny.tiny-closed")
    assert result["correct"], err
