"""Port cache and router against the JAX package: identical state after
identical op sequences for each policy, equal routing decisions, and -1
touches as no-ops."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jax_cache
from repro.core import router as jax_router
from repro_torch.core import cache as port_cache
from repro_torch.core import router as port_router
from repro_torch.core.engine import SharedCacheBank
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

DIM, QT, RT = 32, 8, 12


def _cfgs(policy, capacity=16):
    kw = dict(capacity=capacity, dim=DIM, max_query_tokens=QT, max_response_tokens=RT,
              policy=policy, topk=4, block_n=16)
    return jax_cache.CacheConfig(**kw), port_cache.CacheConfig(**kw)


def _assert_state(port, ref):
    assert set(port) == set(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(port[key].numpy(), np.asarray(val), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def _batch(rng, b):
    embs = rng.standard_normal((b, DIM)).astype(np.float32)
    qt = rng.integers(5, 500, (b, QT)).astype(np.int32)
    qm = (rng.random((b, QT)) < 0.7).astype(np.float32)
    rt = rng.integers(5, 500, (b, RT)).astype(np.int32)
    rm = (rng.random((b, RT)) < 0.7).astype(np.float32)
    return embs, qt, qm, rt, rm


def _insert(jstate, pstate, jcfg, pcfg, arrays, count):
    jstate, jslots = jax_cache.insert_batch(jstate, jcfg, *map(jnp.asarray, arrays), count)
    pstate, pslots = port_cache.insert_batch(pstate, pcfg, *map(torch.from_numpy, arrays),
                                             count)
    assert np.array_equal(pslots.numpy(), np.asarray(jslots))
    _assert_state(pstate, jstate)
    return jstate, pstate


def _queries(rng, state):
    """Exact copies, noisy copies and random vectors of live entries."""
    emb = np.asarray(state["emb"])[np.asarray(state["valid"])]
    noisy = emb[1] + 0.25 * rng.standard_normal(DIM).astype(np.float32) / np.sqrt(DIM)
    q = np.stack([emb[0], noisy, rng.standard_normal(DIM).astype(np.float32), emb[2]])
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _assert_lookup(p_out, j_out):
    s_p, i_p = p_out[0].numpy(), p_out[1].numpy()
    s_j, i_j = np.asarray(j_out[0]), np.asarray(j_out[1])
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5, atol=1e-5)
    fin = np.isfinite(s_j)
    assert np.array_equal(i_p[fin], i_j[fin])
    assert np.all(i_p[~fin] == -1)        # sub-k slots: the Pallas semantics


@pytest.mark.parametrize("policy", ["fifo", "lru", "lfu"])
def test_op_sequence_gives_identical_state(policy):
    rng = np.random.default_rng(["fifo", "lru", "lfu"].index(policy))
    jcfg, pcfg = _cfgs(policy)
    rcfg_j, rcfg_p = jax_router.RouterConfig(), port_router.RouterConfig()
    js, ps = jax_cache.init_cache(jcfg), port_cache.init_cache(pcfg, "cpu")
    _assert_state(ps, js)
    js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 8), 5)
    for step in range(3):
        q = _queries(rng, js)
        jl = jax_cache.lookup_and_touch(js, jcfg, rcfg_j, jnp.asarray(q))
        pl = port_cache.lookup_and_touch(ps, pcfg, rcfg_p, torch.from_numpy(q))
        js = jl[0]
        _assert_lookup(pl[1:3], jl[1:3])
        assert np.array_equal(pl[3].numpy(), np.asarray(jl[3]))
        _assert_state(ps, js)
        idx = np.asarray([3, -1, 3, 7 + step], np.int32)
        js = jax_cache.touch(js, jcfg, jnp.asarray(idx))
        ps = port_cache.touch(ps, pcfg, torch.from_numpy(idx))
        _assert_state(ps, js)
        js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 16), 13 - 4 * step)
    cost = np.asarray([0.1, 0.5, 0.9, 0.5], np.float32)
    q = _queries(rng, js)
    jo = jax_cache.lookup_route_touch(js, jcfg, rcfg_j, jnp.asarray(q), jnp.asarray(cost))
    po = port_cache.lookup_route_touch(ps, pcfg, rcfg_p, torch.from_numpy(q),
                                       torch.from_numpy(cost))
    _assert_lookup(po[1:3], jo[1:3])
    for a, b in zip(po[3:], jo[3:]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    _assert_state(ps, jo[0])


def test_fifo_batch_lapping_the_ring():
    """A batch longer than the ring: the later rows win their slots."""
    rng = np.random.default_rng(7)
    jcfg, pcfg = _cfgs("fifo", capacity=8)
    js, ps = jax_cache.init_cache(jcfg), port_cache.init_cache(pcfg, "cpu")
    js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 4), 3)
    js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 32), 21)
    js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 4), 0)


def test_touch_minus_one_is_a_noop():
    _, pcfg = _cfgs("lru", capacity=8)
    ps = port_cache.init_cache(pcfg, "cpu")
    rng = np.random.default_rng(1)
    ps, _ = port_cache.insert_batch(ps, pcfg, *map(torch.from_numpy, _batch(rng, 8)), 8)
    before = {k: v.clone() for k, v in ps.items()}
    ps = port_cache.touch(ps, pcfg, torch.tensor([-1, -1], dtype=torch.int32))
    for k in before:
        if k != "clock":
            assert torch.equal(ps[k], before[k]), k
    assert int(ps["clock"]) == int(before["clock"]) + 1
    assert int(ps["last_used"][-1]) == int(before["last_used"][-1])


def test_off_slice_cache_configs_raise():
    with pytest.raises(ValueError, match="index"):
        port_cache.CacheConfig(index="hnsw")
    # a band without a reranker has no stage 2 to resolve its rows
    with pytest.raises(ValueError, match="reranker"):
        SharedCacheBank(port_cache.CacheConfig(capacity=8, dim=4),
                        port_router.RouterConfig(band=0.1), device="cpu")


@pytest.mark.parametrize("kw", [{}, {"tweak_threshold": 0.8, "default_cost": 0.3},
                                {"cal_costs": (0.0, 0.4, 1.0), "cal_taus": (0.5, 0.75, 0.95)}])
def test_router_matches_jax(kw):
    jcfg, pcfg = jax_router.RouterConfig(**kw), port_router.RouterConfig(**kw)
    cost = np.concatenate([np.linspace(0, 1, 41), [pcfg.default_cost, -0.2, 1.3]])
    cost = cost.astype(np.float32)
    tau_j = np.asarray(jax_router.threshold_for(jnp.asarray(cost), jcfg))
    tau_p = port_router.threshold_for(torch.from_numpy(cost), pcfg).numpy()
    np.testing.assert_allclose(tau_p, tau_j, rtol=0, atol=1e-7)
    assert tau_p[-3] == np.float32(pcfg.tweak_threshold) or kw.get("cal_costs")
    scores = np.linspace(-1, 1.001, 301).astype(np.float32)
    scores = np.concatenate([scores, [0.7, 0.8, 0.9, 0.9999, 1.0]]).astype(np.float32)
    s_t, s_j = torch.from_numpy(scores), jnp.asarray(scores)
    assert np.array_equal(port_router.route(s_t, pcfg).numpy(),
                          np.asarray(jax_router.route(s_j, jcfg)))
    assert np.array_equal(port_router.band_of(s_t, pcfg).numpy(),
                          np.asarray(jax_router.band_of(s_j, jcfg)))
    assert port_router.bands_for(pcfg) == jax_router.bands_for(jcfg)
    tau = np.full_like(scores, tau_j[7])
    assert np.array_equal(
        port_router.route_cascade(s_t, torch.from_numpy(tau), pcfg).numpy(),
        np.asarray(jax_router.route_cascade(s_j, jnp.asarray(tau), jcfg)))
