"""The port's engine with the IVF index and per-cluster admission against
the JAX package's on one greedy trace (the trace, weights and comparisons of
tests/test_torch_engine.py): decisions, similarities, responses,
``EngineStats`` (``suppressed_inserts`` included) and the whole bank state,
IVF and admission keys included, must agree."""
import dataclasses

import numpy as np
import pytest

from repro.core import TweakLLMEngine as JaxEngine
from repro.launch.serve import build_stack as jax_build_stack
from repro_torch.core import router
from test_torch_engine import CAPACITY, MNT, THRESHOLD, VOCAB, _port_engine, _trace
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

CASES = {
    # full probe: the flat scan's results (tests/test_index.py's engine check)
    "full-probe": (dict(nclusters=4, nprobe=4), {}, {}),
    # auto table at capacity 64: 64 clusters, 8 probed, a cold index throughout
    "default-probe": (dict(nclusters=0, nprobe=8), {}, {}),
    # one cold cluster whose hit EMA falls under the floor: later misses are
    # served but not cached
    "admission": (dict(nclusters=4, nprobe=2, admit_floor=0.95), {},
                  dict(admit_min=2)),
    # a k-means rebuild inside the engine after the first commits
    "reindex": (dict(nclusters=4, nprobe=2), dict(reindex_every=8), {}),
}


def _engines(case):
    stack_kw, cache_kw, router_kw = CASES[case]
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD, index="ivf", **stack_kw)
    jstack["cache_cfg"] = dataclasses.replace(jstack["cache_cfg"], **cache_kw)
    jstack["router_cfg"] = dataclasses.replace(jstack["router_cfg"], **router_kw)
    return JaxEngine(**jstack), _port_engine(jstack)


def _serve(eng, batches):
    return [eng.handle_batch(b, max_new_tokens=MNT, collect_meta=True) for b in batches]


@pytest.mark.parametrize("case", list(CASES))
def test_ivf_engine_trace_matches_jax(case):
    jeng, peng = _engines(case)
    assert peng.cache_cfg.index == "ivf"
    pairs, batches = _trace()
    jeng.populate(*pairs)
    peng.populate(*pairs)
    seen = set()
    for (jr, jm), (pr, pm) in zip(_serve(jeng, batches), _serve(peng, batches)):
        for a, b in zip(pm, jm):
            assert min(abs(b["sim"] - THRESHOLD), abs(b["sim"] - 0.9999)) > 5e-5
            assert a["decision"] == b["decision"]
            assert a["sim"] == pytest.approx(b["sim"], abs=1e-5)
            assert (a["band"], a["gen_tokens"]) == (b["band"], b["gen_tokens"])
        assert pr == jr
        seen |= {m["decision"] for m in pm}
    assert seen == {router.MISS, router.TWEAK, router.EXACT}
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    assert (peng.stats.suppressed_inserts > 0) == (case == "admission")
    assert peng.bank.insert_seq == jeng.bank.insert_seq
    for key, val in jeng.state.items():
        want = np.asarray(val)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(peng.state[key].numpy(), want, atol=1e-5, err_msg=key)
        else:
            assert np.array_equal(peng.state[key].numpy(), want), key
    assert set(peng.state) == set(jeng.state)
    assert peng.bank.text_store == jeng.bank.text_store
    if case == "reindex":
        assert np.asarray(jeng.state["ivf_centroids"]).any()   # the rebuild happened


def test_port_full_probe_ivf_engine_matches_flat_engine():
    """Within the port: at nprobe == nclusters the IVF engine serves the flat
    engine's responses and stats (the JAX package's own engine check)."""
    from repro_torch.launch.serve import build_engine
    flat = build_engine(device="cpu", capacity=64, threshold=0.7, train_embedder_steps=0)
    ivf = build_engine(device="cpu", capacity=64, threshold=0.7, index="ivf", nclusters=4,
                       nprobe=4, train_embedder_steps=0)
    batches = [["how do i sort a list in python", "what is the capital of france"],
               ["how do i sort a list in python", "explain http caching briefly"],
               ["what is the capital of france", "how do i sort a python list"]]
    for qs in batches:
        assert flat.handle_batch(qs, max_new_tokens=4) == ivf.handle_batch(qs, max_new_tokens=4)
    assert flat.stats == ivf.stats and flat.stats.exact > 0
