"""The port's hot-path analyzer (``repro_torch.analysis``) on the CPU.

The lint's rules on violating, clean and waived fixtures (mirroring
``tests/test_analysis_lint.py``), parity with the reference's
``repro.analysis.lint.lint_source`` on snippets whose rules are the same
in both trees (the same rule ids at the same lines), the tree clean; the
sync counter's rules; the contracts clean on the CPU, and each injected
fault caught: an extra ``.item()`` in a hot path, a state leaf reallocated,
a write to the prefix KV, a float64 promotion, a per-step sync in the fused
decode.
"""
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import lint as jax_lint
from repro_torch.analysis import contracts, lint, registry
from repro_torch.analysis.lint import check_registry, lint_source, lint_tree
from repro_torch.analysis.registry import HotPath
from repro_torch.device import to_device
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

HOT = "core/engine.py"      # inside registry.HOT_MODULES (the reference's too)
COLD = "eval/metrics.py"    # host-sync rules must not fire here


def rules(src, rel=HOT):
    return [v.rule for v in lint_source(textwrap.dedent(src), rel)]


# ------------------------------------------------------------- HS1xx ----

def test_hs101_item_flagged_hot_only():
    src = """
    def f(x):
        return x.item()
    """
    assert rules(src) == ["HS101"]
    assert rules(src, rel=COLD) == []


def test_hs101_waived_on_line():
    assert rules("""
    def f(x):
        return x.item()  # hostsync: ok the one per-batch sync
    """) == []


def test_hs102_int_on_tensor_flagged_static_reads_exempt():
    assert rules("""
    def f(x):
        return int(x)
    """) == ["HS102"]
    assert rules("""
    def f(x, xs):
        return int(x.shape[0]) + int(len(xs)) + int(3) + int(x.size(1)) + int(x.numel())
    """) == []


@pytest.mark.parametrize("call", [
    "x.cpu()", "x.numpy()", "x.tolist()", 'x.to("cpu")', 'x.to(torch.device("cpu"))',
    'x.to(device="cpu")', "torch.cuda.synchronize()", "torch.cuda.current_stream().synchronize()",
])
def test_hs103_torch_spellings_flagged(call):
    assert rules(f"""
    import torch

    def f(x):
        return {call}
    """) == ["HS103"]


def test_hs103_one_flag_per_chain_and_host_arrays_exempt():
    # the chain's copy is flagged once, at .cpu()
    assert rules("""
    def f(x):
        return x.cpu().numpy().tolist()
    """) == ["HS103"]
    # evidently numpy: a np.* call, or a chain through .astype (tensors lack it)
    assert rules("""
    import numpy as np

    def f(mask):
        return np.asarray(mask).tolist(), mask.sum(axis=1).astype(np.int64).tolist()
    """) == []
    # a device move is not a host copy
    assert rules("""
    def f(x, dev):
        return x.to(dev), x.to("cuda")
    """) == []


def test_hs103_waiver_on_previous_line():
    assert rules("""
    def f(x):
        # hostsync: ok the one per-batch sync
        return x.cpu()
    """) == []


def test_hs104_bool_flagged():
    assert rules("""
    def f(x):
        return bool(x)
    """) == ["HS104"]


def test_hostsync_def_line_waiver_covers_whole_function():
    assert rules("""
    def rebuild(x):  # hostsync: ok host-driven maintenance path
        n = int(x)
        return n, x.item(), x.cpu()
    """) == []
    assert rules("""
    def rebuild(x):  # hostsync: ok host-driven maintenance path
        return int(x)

    def serve(x):
        return int(x)
    """) == ["HS102"]


# ------------------------------------------------------------- SD2xx ----

@pytest.mark.parametrize("call", ["torch.manual_seed(0)", "torch.cuda.manual_seed_all(3)",
                                  "torch.Generator().manual_seed(0)", "gen.manual_seed(1)"])
def test_sd201_literal_seed_flagged_everywhere(call):
    src = f"""
    import torch

    def f(gen):
        return {call}
    """
    assert rules(src) == ["SD201"]
    assert rules(src, rel=COLD) == ["SD201"]


def test_sd201_threaded_seed_clean_and_waiver_works():
    assert rules("""
    import torch

    def f(gen, seed):
        return gen.manual_seed(seed), torch.manual_seed(int(seed))
    """, rel=COLD) == []
    assert rules("""
    def f(gen):
        return gen.manual_seed(1)  # seed: ok demo CLI, determinism wanted
    """) == []


def test_sd202_literal_seed_kwarg_but_not_api_default():
    assert rules("""
    def f(gen):
        return gen.generate(seed=0)
    """) == ["SD202"]
    assert rules("""
    def generate(batch, seed: int = 0):
        return batch, seed
    """) == []


def test_sd202_anchored_at_kwarg_line_in_multiline_call():
    assert rules("""
    def f(gen, batch):
        return gen.generate(batch,
                            seed=0)  # seed: ok differential oracle replay
    """) == []


# ------------------------------------------------------------- IS301 ----

def test_is301_import_time_environ_mutation():
    assert rules("""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    """, rel=COLD) == ["IS301"]


@pytest.mark.parametrize("stmt", [
    "torch.backends.cuda.matmul.allow_tf32 = False", "torch.set_default_dtype(torch.float64)",
    "torch.set_num_threads(1)", 'torch.set_float32_matmul_precision("high")',
    "torch.manual_seed(seed)",
])
def test_is301_torch_process_state(stmt):
    assert rules(f"""
    import torch
    seed = 1
    {stmt}
    """, rel=COLD) == ["IS301"]
    assert rules(f"""
    import torch

    def main(seed):
        {stmt}
    """, rel=COLD) == []


def test_is301_reaches_into_module_level_if():
    assert rules("""
    import torch
    if torch.cuda.is_available():
        torch.backends.cudnn.allow_tf32 = False
    """, rel=COLD) == ["IS301"]


def test_is301_waiver():
    assert rules("""
    import torch
    torch.set_num_threads(1)  # import-side-effect: ok test harness, one thread wanted
    """, rel=COLD) == []


# --------------------------------------------------- parity with JAX lint

SHARED = {
    "hs101": "def f(x):\n    a = 1\n    return x.item() + a\n",
    "hs102": "def f(x, y):\n    n = int(x)\n    m = float(y.val)\n    return n, m, int(3), float(len(y))\n",
    "hs102_static": "def f(x):\n    return int(x.shape[0]) + int(x.ndim) + float(x.size)\n",
    "hs104": "def f(x):\n    if bool(x):\n        return bool(x > 1)\n",
    "waived": "def f(x):\n    return x.item()  # hostsync: ok the one per-batch sync\n",
    "def_waiver": ("def g(x):  # hostsync: ok maintenance\n    return int(x)\n\n\n"
                   "def h(x):\n    return bool(x)\n"),
    "sd202": "def f(gen, b):\n    gen.generate(b, seed=0)\n    return gen.generate(b,\n"
             "                        seed=0)\n",
    "sd202_waived": "def f(gen):\n    return gen.generate(seed=0)  # seed: ok replay\n",
    "is301": ("import os\nimport sys\nimport warnings\nos.environ['A'] = '1'\n"
              "warnings.filterwarnings('ignore')\nsys.path.insert(0, '.')\n"
              "if 'B' not in os.environ:\n    os.environ['B'] = '2'\n"),
}


@pytest.mark.parametrize("name", sorted(SHARED))
@pytest.mark.parametrize("rel", [HOT, COLD])
def test_rules_and_lines_match_the_reference_lint(name, rel):
    want = [(v.rule, v.line) for v in jax_lint.lint_source(SHARED[name], rel)]
    got = [(v.rule, v.line) for v in lint_source(SHARED[name], rel)]
    assert got == want
    if rel == HOT and name not in ("waived", "sd202_waived", "hs102_static"):
        assert got


# ------------------------------------------------------------- JR403 ----

def test_jr403_stale_and_unscanned_entries():
    table = (HotPath("core/cache.py", "lookup", 0, note="kept"),
             HotPath("core/cache.py", "gone_function", 0, note="stale"),
             HotPath("core/moved.py", "f", 0, note="unscanned"))
    vs = check_registry({"core/cache.py": {"lookup", "insert_batch"}}, table)
    assert [(v.rule, v.rel) for v in vs] == [("JR403", "core/cache.py"),
                                            ("JR403", "core/moved.py")]
    assert check_registry({"core/cache.py": {"lookup"}}, table[:1]) == []


def test_hot_path_entries_need_a_note():
    with pytest.raises(ValueError):
        HotPath("core/cache.py", "lookup", 0)


# ------------------------------------------------------- repo-clean gate

def test_repo_tree_is_lint_clean():
    vs = lint_tree()
    assert vs == [], "\n".join(str(v) for v in vs)


def test_every_waiver_names_its_sync():
    import pathlib
    root = pathlib.Path(lint.find_root())
    for path in root.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            for token in lint.WAIVER_TOKENS.values():
                if token in line and path.name != "lint.py":
                    reason = line.split(token, 1)[1].strip(" ;")
                    assert len(reason) >= 8, f"{path}:{i}: waiver without a reason"


def test_hot_set_matches_layout():
    assert registry.is_hot("core/cache.py")
    assert registry.is_hot("models/ssm.py")
    assert registry.is_hot("kernels/cosine_topk/ops.py")
    assert not registry.is_hot("eval/metrics.py")
    assert not registry.is_hot("analysis/lint.py")
    from repro.analysis import registry as jax_registry
    assert registry.HOT_MODULES == jax_registry.HOT_MODULES


def test_cli_reports_clean(capsys):
    assert lint.main([]) == 0
    assert "clean" in capsys.readouterr().out


# ------------------------------------------------------- the sync counter

def _count(fn):
    with contracts.counting("cpu") as c:
        fn()
    return c


def test_counter_counts_reads_of_device_tensors_only():
    x = to_device(np.arange(6, dtype=np.float32), torch.device("cpu")) * 2

    def reads():
        host = torch.as_tensor(np.arange(4))      # made from numpy: host data
        return (x.sum().item(), x.cpu().numpy(), host.tolist(), x.tolist(), bool(x[0] > 1),
                int(x[1]))
    c = _count(reads)
    assert c.total == 5 and c.kinds == {"read": 5}
    assert all(site.startswith("test_torch_analysis.py:") for site in c.syncs)


def test_counter_counts_data_dependent_shapes_and_blocking_uploads():
    x = torch.arange(8, dtype=torch.float32, device="cpu")
    c = _count(lambda: (torch.nonzero(x), x[x > 3], x.unique()))
    assert c.kinds == {"shape": 3}
    y = torch.zeros(8, device="cpu")

    def masked_fill():
        y[y > 0] = 1.0                      # masked_fill_: no sync
    assert _count(masked_fill).total == 0
    c = _count(lambda: (x[[0, 2]], torch.tensor([1, 2], device="cpu"),
                        torch.as_tensor(np.ones(3)).to("cpu"), y.copy_(torch.ones(8))))
    assert c.kinds == {"upload": 4}
    assert _count(lambda: to_device(np.ones(3), torch.device("cpu"))).total == 0


def test_counter_flags_widening_but_not_index_ops_or_asked_int64():
    x = torch.randn(4, 5, device="cpu")
    i = torch.arange(4, dtype=torch.int32, device="cpu")
    assert _count(lambda: (x.topk(2), x.argmax(1), i.long(), i.to(torch.int64),
                           torch.zeros(3, dtype=torch.int64, device="cpu"),
                           i.sum(dtype=torch.int32))).wide == []
    c = _count(lambda: (torch.arange(3, device="cpu"), i.sum(), torch.where(x > 0, 1, 2),
                        x.double()))
    assert [w.split()[-1] for w in c.wide] == ["int64", "int64", "int64", "float64"]


# -------------------------------------------------------------- contracts

@pytest.mark.parametrize("name", [n for n, _ in contracts.CONTRACTS])
def test_contract_clean_on_the_cpu(name):
    fn = dict(contracts.CONTRACTS)[name]
    with torch.no_grad() if name != "train_step" else torch.enable_grad():
        assert fn("cpu") == []


def test_spec_contract_runs_the_reference_tiny_generator(monkeypatch):
    """The speculative contract runs on the reference's tiny generator (2
    layers, 2 heads over 1 KV head, head dim 16, fp32), as the plain one
    does, and is clean there."""
    built, inner = [], contracts._tiny_generator

    def spy(*args, **kw):
        built.append(inner(*args, **kw))
        return built[-1]

    monkeypatch.setattr(contracts, "_tiny_generator", spy)
    with torch.no_grad():
        assert contracts.contract_spec_decode("cpu", buckets=(1,)) == []
    cfg = built[0].model.cfg
    assert built[0].cfg.spec_k == 2
    assert (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.dtype) == (2, 2, 1, 16, "float32")


def test_contracts_cli_on_the_cpu(capsys):
    assert contracts.main(["--device", "cpu"]) == 0
    assert "clean on cpu" in capsys.readouterr().out


def _fails(fn, *args, **kw):
    with torch.no_grad():
        return fn("cpu", *args, **kw)


def test_an_extra_item_in_a_hot_path_is_caught(monkeypatch):
    from repro_torch.core import cache
    inner = cache.lookup_and_touch

    def leaky(*a, **k):
        out = inner(*a, **k)
        out[1][0, 0].item()
        return out
    monkeypatch.setattr(cache, "lookup_and_touch", leaky)
    f = _fails(contracts.contract_lookup_and_touch, (2,))
    assert f and all("host syncs, budget 0" in x for x in f)


def test_a_reallocated_state_leaf_is_caught(monkeypatch):
    from repro_torch.core import cache
    inner = cache._touch_rows

    def realloc(state, *a, **k):
        out = inner(state, *a, **k)
        state["hits"] = state["hits"] + 0
        return out
    monkeypatch.setattr(cache, "_touch_rows", realloc)
    f = _fails(contracts.contract_lookup_and_touch, (2,))
    assert f and all("reallocated" in x and "'/hits'" in x for x in f)


def test_a_write_to_the_prefix_kv_is_caught(monkeypatch):
    from repro_torch.models.model import Model
    inner = Model.prefill_with_prefix

    def scribble(self, params, batch, capacity, prefix):
        out = inner(self, params, batch, capacity, prefix)
        next(iter(contracts._leaves(prefix).values())).add_(0)
        return out
    monkeypatch.setattr(Model, "prefill_with_prefix", scribble)
    f = _fails(contracts.contract_prefix_suffix_prefill)
    assert f and all("prefix_cache written" in x for x in f)


def test_a_float64_promotion_is_caught(monkeypatch):
    from repro_torch.core import router
    inner = router.route
    monkeypatch.setattr(router, "route", lambda scores, cfg: inner(scores.double(), cfg))
    f = _fails(contracts.contract_lookup_and_touch, (2,))
    assert f and all("64-bit widening" in x and "float64" in x for x in f)


def test_a_per_step_sync_in_the_fused_decode_is_caught(monkeypatch):
    from repro_torch.serving import generate
    inner = generate.masked_sample

    def syncing(logits, done, *a, **k):
        bool(done.any())
        return inner(logits, done, *a, **k)
    monkeypatch.setattr(generate, "masked_sample", syncing)
    f = _fails(contracts.contract_fused_decode, (1,))
    assert any("decode_fused[b=1]" in x and "budget 0" in x for x in f)
    assert any("generate[b=1,mnt=8]" in x and "want exactly 1" in x for x in f)
