"""BENCHMARK.json against the contract's shape, every entry resolved to its
files by name, and a configuration, a traffic mix and a metric added by
files and entries alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import check, harness
from portbench.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1] == "portbench/run.py"
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_every_entry_resolves_to_its_files(spec):
    for cell in spec["workloads"]:
        c, conf, cfg, traffic, limits = harness.resolve(ROOT, spec, cell["name"])
        assert cfg["serving"]["bank_rows"] > 0 and traffic["loop"] in ("closed", "open")
        assert set(limits) <= set(check.NUMBERS) and limits["mismatch"] == 0
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert harness.metrics_of(spec, cell, True), cell["name"]
    for m in spec["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"]))
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_a_variant_without_a_file_of_its_own_is_read_by_its_base(tmp_path):
    """``dispatch_ms.closed`` and ``dispatch_ms.open`` share
    ``metrics/dispatch_ms.py``; a file ``<base>.<variant>.py`` comes first."""
    root = tiny.make_root(tmp_path)
    d = root / "portbench" / "metrics"
    (d / "rows.py").write_text("def read(ctx):\n    return 1.0\n")
    (d / "rows.open.py").write_text("def read(ctx):\n    return 2.0\n")
    assert harness.reader(root, "rows.closed")(None) == 1.0
    assert harness.reader(root, "rows.open")(None) == 2.0
    assert harness.reader(root, "rows")(None) == 1.0


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w]), (m["name"], w)
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert {"front end", "entry", "lookup + route", "TWEAK", "MISS", "kernels", "model step",
            "device"} <= set(layers)


def test_config_files_state_no_width_cut(spec):
    widths = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|"
                        r"experts_per_token|d_model|d_ff)")
    for conf in spec["configs"]:
        assert not [k for k in conf["reduced"] if widths.search(k)], conf["reduced"]
        cfg = json.loads((ROOT / conf["file"]).read_text())
        for k in conf["reduced"]:
            if k != "small":
                assert k in cfg["published"] and cfg["published"][k] != cfg[k]


def test_a_new_config_traffic_and_metric_are_found_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    shutil.copy(pb / "configs" / "tiny.json", pb / "configs" / "tiny2.json")
    (pb / "traffic" / "tiny-wild.json").write_text(json.dumps(
        dict(tiny.TRAFFIC["tiny-closed"], queries={"kind": "workload", "alpha": 0.25,
                                                   "exact_repeat": 0.0})))
    (pb / "limits" / "tiny2.tiny-wild.json").write_text(json.dumps(tiny.LIMITS))
    (pb / "metrics" / "rows_seen.closed.py").write_text(
        "def read(ctx):\n    return float(sum(len(d['texts']) for d in ctx.dispatches))\n")
    spec["configs"].append({"name": "tiny2", "source": "https://example.org/tiny2",
                            "file": "portbench/configs/tiny2.json", "reduced": [],
                            "why": "a second"})
    spec["workloads"].append({"name": "tiny2.tiny-wild", "config": "tiny2",
                              "traffic": "tiny-wild", "chips": 1, "why": "added by files"})
    spec["per_layer"].append({"name": "rows_seen.closed", "unit": "rows", "better": "higher",
                              "source": "program_span", "layer": "front end",
                              "moves": "req_per_s", "workloads": ["tiny2.tiny-wild"]})
    for m in spec["end_to_end"]:
        if m["name"] == "req_per_s":
            m["workloads"].append("tiny2.tiny-wild")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = harness.load_spec(root)
    cell, conf, cfg, traffic, limits = harness.resolve(root, spec, "tiny2.tiny-wild")
    assert traffic["queries"]["alpha"] == 0.25 and conf["name"] == "tiny2"
    names = [m["name"] for m in harness.metrics_of(spec, cell, True)]
    assert names == ["rows_seen.closed"]

    class Ctx:
        dispatches = [{"texts": ["a", "b"]}, {"texts": ["c"]}]
    assert harness.reader(root, "rows_seen.closed")(Ctx) == 3.0
