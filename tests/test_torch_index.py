"""The port's IVF index and per-cluster admission against the JAX package:
the same numpy inputs go through ``repro.core.{cache,index,router}`` and
their ports.  Integer state must be equal, float state within 1e-6, lookup
scores within 1e-5 with equal indices, as in tests/test_index.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jax_cache
from repro.core import index as jax_index
from repro.core import router as jax_router
from repro_torch.checkpoint import jax_cache_state_to_torch
from repro_torch.core import cache as port_cache
from repro_torch.core import index as port_index
from repro_torch.core import router as port_router

DIM, QT, RT = 16, 4, 6


def _cfgs(capacity=32, lookup_impl="xla", **kw):
    """(JAX config, port config); ``lookup_impl`` picks the JAX lookup path
    (the port's is the kernel on CUDA, the plain version here)."""
    base = dict(capacity=capacity, dim=DIM, max_query_tokens=QT, max_response_tokens=RT,
                topk=4, block_n=16, index="ivf")
    base.update(kw)
    return (jax_cache.CacheConfig(lookup_impl=lookup_impl, **base),
            port_cache.CacheConfig(**base))


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clustered(rng, n, ntrue=6, noise=0.3):
    centers = _unit(rng, (ntrue, DIM))
    pts = centers[rng.integers(0, ntrue, n)] + noise / DIM ** 0.5 * \
        rng.standard_normal((n, DIM)).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


def _batch(rng, b, embs=None):
    embs = rng.standard_normal((b, DIM)).astype(np.float32) if embs is None else embs
    return (embs, rng.integers(5, 500, (b, QT)).astype(np.int32),
            np.ones((b, QT), np.float32), rng.integers(5, 500, (b, RT)).astype(np.int32),
            np.ones((b, RT), np.float32))


def _port_state(js, pcfg):
    return jax_cache_state_to_torch({k: np.asarray(v) for k, v in js.items()}, pcfg,
                                    device="cpu")


def _assert_state(ps, js, atol=1e-6):
    assert set(ps) == set(js)
    for key, val in js.items():
        want, got = np.asarray(val), ps[key].numpy()
        assert got.dtype == want.dtype, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)
        else:
            assert np.array_equal(got, want), key


def _insert(js, ps, jcfg, pcfg, arrays, count):
    js, jslots = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, arrays), count)
    ps, pslots = port_cache.insert_batch(ps, pcfg, *map(torch.from_numpy, arrays), count)
    assert np.array_equal(pslots.numpy(), np.asarray(jslots))
    _assert_state(ps, js)
    return js, ps


def _assert_lookup(p_out, j_out):
    s_p, i_p = p_out[0].numpy(), p_out[1].numpy()
    s_j, i_j = np.asarray(j_out[0]), np.asarray(j_out[1])
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5, atol=1e-5)
    fin = np.isfinite(s_j)
    assert np.array_equal(np.isfinite(s_p), fin)
    assert np.array_equal(i_p[fin], i_j[fin])
    assert np.all(i_p[~fin] == -1)


@pytest.mark.parametrize("kw", [
    dict(capacity=64), dict(capacity=65536), dict(capacity=262144),
    dict(capacity=1 << 20), dict(capacity=64, nclusters=4, ivf_bucket=2),
    dict(capacity=100, nclusters=7, nprobe=0, topk=8), dict(capacity=3, topk=4),
    dict(capacity=4096, nclusters=16, nprobe=32, reindex_every=10, ivf_bucket=300),
])
def test_resolve_matches_jax(kw):
    jcfg, pcfg = _cfgs(**kw)
    assert port_index.resolve(pcfg) == port_index.IVFParams(
        **vars(jax_index.resolve(jcfg)))


def test_llama_bank_resolves_to_the_main_path_probe():
    p = port_index.resolve(port_cache.CacheConfig(capacity=262_144, index="ivf"))
    assert (p.nclusters, p.bucket, p.nprobe) == (2048, 256, 8)


@pytest.mark.parametrize("policy", ["fifo", "lru", "lfu"])
def test_insert_sequence_matches_jax(policy):
    """Inserts under a small bucket (nearest list full -> least-loaded
    fallback -> overflow), lapped FIFO batches, lookups and touches: every
    cache, IVF and admission key and every slot equal JAX's."""
    rng = np.random.default_rng(["fifo", "lru", "lfu"].index(policy) + 10)
    jcfg, pcfg = _cfgs(capacity=16, nclusters=3, ivf_bucket=6, policy=policy,
                       reindex_every=10 ** 6)
    js = jax_cache.init_cache(jcfg)
    js["ivf_centroids"] = jnp.asarray(_unit(rng, (3, DIM)))
    ps = _port_state(js, pcfg)
    _assert_state(ps, js)
    rcfg_j = jax_router.RouterConfig(tweak_threshold=0.6, admit_floor=0.5, admit_min=2)
    rcfg_p = port_router.RouterConfig(tweak_threshold=0.6, admit_floor=0.5, admit_min=2)
    for b, count in ((8, 5), (8, 8), (32, 21), (4, 0), (8, 7), (16, 16)):
        js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, b), count)
        emb = np.asarray(js["emb"])[np.asarray(js["valid"])]
        q = np.concatenate([emb[:2], _unit(rng, (2, DIM))])
        cost = np.full((4,), 0.5, np.float32)
        jo = jax_cache.lookup_route_touch(js, jcfg, rcfg_j, jnp.asarray(q), jnp.asarray(cost))
        po = port_cache.lookup_route_touch(ps, pcfg, rcfg_p, torch.from_numpy(q),
                                           torch.from_numpy(cost))
        _assert_lookup(po[1:3], jo[1:3])
        for a, c in zip(po[3:], jo[3:]):
            assert np.array_equal(a.numpy(), np.asarray(c))
        js = jo[0]
        _assert_state(ps, js)
    assert bool(js["ivf_overflow"])             # the churn did overflow the table
    assert int(np.asarray(js["adm_count"]).sum()) > 0


def _filled(rng, jcfg, n):
    js = jax_cache.init_cache(jcfg)
    js, _ = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, _batch(rng, n, _clustered(rng, n))),
                                   n)
    return js


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("probe", ["default", "full", "cold"])
def test_lookup_matches_jax(impl, probe):
    """``index.lookup`` against JAX's under both JAX lookup paths (Pallas in
    interpret mode), at the default nprobe, at nprobe == nclusters and on a
    cold index (zero centroids: the probes are clusters 0..nprobe-1)."""
    rng = np.random.default_rng(["default", "full", "cold"].index(probe))
    nprobe = {"default": 2, "full": 8, "cold": 3}[probe]
    jcfg, pcfg = _cfgs(capacity=64, nclusters=8, nprobe=nprobe, lookup_impl=impl)
    js = _filled(rng, jcfg, 60)
    if probe != "cold":
        js = jax_index.build_index(js, jcfg, seed=1)
    else:
        assert not np.asarray(js["ivf_centroids"]).any()
    ps = _port_state(js, pcfg)
    emb = np.asarray(js["emb"])
    q = np.concatenate([emb[[3, 17, 40]], _unit(rng, (3, DIM)),
                        _clustered(rng, 2)]).astype(np.float32)
    _assert_lookup(port_index.lookup(ps, pcfg, torch.from_numpy(q)),
                   jax_index.lookup(js, jcfg, jnp.asarray(q)))
    if probe == "cold":
        probes = port_index.probe_clusters(ps["ivf_centroids"], torch.from_numpy(q), nprobe)
        assert probes.tolist() == [[0, 1, 2]] * len(q)


@pytest.mark.parametrize("policy", ["fifo", "lru"])
def test_full_probe_equals_port_flat_lookup(policy):
    """At nprobe == nclusters the port's IVF lookup gives its flat scan's
    scores (and indices where no two scores tie), through overwrite churn
    and a rebuild."""
    rng = np.random.default_rng(5)
    _, pcfg = _cfgs(capacity=32, nclusters=4, nprobe=4, policy=policy, reindex_every=10 ** 6)
    fcfg = port_cache.CacheConfig(**{**vars(pcfg), "index": "flat"})
    ps = port_cache.init_cache(pcfg, "cpu")
    for b, count in ((16, 16), (16, 12), (32, 30)):
        port_cache.insert_batch(ps, pcfg, *map(torch.from_numpy, _batch(rng, b)), count)
    q = torch.from_numpy(_unit(rng, (6, DIM)))
    for rebuild in (False, True):
        if rebuild:
            port_index.build_index(ps, pcfg, seed=3)
        assert torch.equal(port_index.live_entries_per_slot(ps), ps["valid"].long())
        fs, fi = port_cache.lookup(ps, fcfg, q)
        vs, vi = port_cache.lookup(ps, pcfg, q)
        np.testing.assert_allclose(vs.numpy(), fs.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(vi, fi)


def test_build_index_matches_jax_with_spill():
    """k-means and filing on a clustered bank whose bucket is too small for
    its largest cluster (the spill path): members, count, assign and pos
    equal JAX's, centroids within 1e-5, admission statistics reset."""
    rng = np.random.default_rng(11)
    jcfg, pcfg = _cfgs(capacity=96, nclusters=4, ivf_bucket=24, kmeans_iters=6)
    js = jax_cache.init_cache(jcfg)
    pts = _clustered(rng, 90, ntrue=4, noise=0.4)
    pts[:40] = _clustered(np.random.default_rng(12), 40, ntrue=1, noise=0.4)   # one crowd
    js, _ = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, _batch(rng, 90, pts)), 90)
    js["adm_ema"] = jnp.full_like(js["adm_ema"], 0.25)
    js["adm_count"] = jnp.full_like(js["adm_count"], 9)
    ps = _port_state(js, pcfg)
    jr = jax_index.build_index(js, jcfg, seed=4)
    pr = port_index.build_index(ps, pcfg, seed=4)
    assert pr is ps
    _assert_state(ps, jr, atol=1e-5)
    counts = np.bincount(np.asarray(jr["ivf_assign"])[:90], minlength=4)
    assert counts.max() == 24                   # a cluster was cut to its bucket ...
    per_slot = port_index.live_entries_per_slot(ps).numpy()
    assert np.array_equal(per_slot, np.arange(96) < 90)   # ... and every valid row kept a place


def test_maybe_reindex_matches_jax():
    """Fires on pending writes and on overflow exactly when JAX's does, and
    rebuilds to JAX's table."""
    rng = np.random.default_rng(2)
    jcfg, pcfg = _cfgs(capacity=16, nclusters=2, reindex_every=10)
    js = jax_cache.init_cache(jcfg)
    ps = port_cache.init_cache(pcfg, "cpu")
    fired = []
    for count in (4, 5, 3, 2, 8):
        js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 8), count)
        js, jdid = jax_index.maybe_reindex(js, jcfg, seed=count)
        ps, pdid = port_index.maybe_reindex(ps, pcfg, seed=count)
        assert pdid == jdid
        fired.append(pdid)
        _assert_state(ps, js)
    assert fired == [False, False, True, False, True]
    # overflow: a bucket of 4 over 8 slots with a rebuild far away
    jcfg, pcfg = _cfgs(capacity=8, nclusters=2, ivf_bucket=4, reindex_every=10 ** 6)
    js = jax_cache.init_cache(jcfg)
    ps = port_cache.init_cache(pcfg, "cpu")
    fired = []
    for _ in range(4):
        js, ps = _insert(js, ps, jcfg, pcfg, _batch(rng, 4), 4)
        js, jdid = jax_index.maybe_reindex(js, jcfg)
        ps, pdid = port_index.maybe_reindex(ps, pcfg)
        assert pdid == jdid
        fired.append(pdid)
        _assert_state(ps, js)
    assert fired == [False, False, True, True]
    flat = port_cache.CacheConfig(capacity=8, dim=DIM)
    assert port_index.maybe_reindex(port_cache.init_cache(flat, "cpu"), flat)[1] is False


@pytest.mark.parametrize("floor,min_obs", [(0.0, 16), (0.5, 2), (0.9, 0)])
def test_admission_matches_jax(floor, min_obs):
    rng = np.random.default_rng(int(floor * 10))
    kw = dict(admit_floor=floor, admit_min=min_obs, admit_alpha=0.2)
    jcfg, pcfg = jax_router.RouterConfig(**kw), port_router.RouterConfig(**kw)
    ema = rng.random(5).astype(np.float32)
    cnt = rng.integers(0, 4, 5).astype(np.int32)
    for _ in range(4):
        cluster = rng.integers(-1, 5, 12).astype(np.int32)
        hit, obs = rng.random(12) < 0.4, rng.random(12) < 0.8
        ja = jax_router.admission_admit(jnp.asarray(ema), jnp.asarray(cnt),
                                        jnp.asarray(cluster), jcfg)
        pa = port_router.admission_admit(torch.from_numpy(ema), torch.from_numpy(cnt),
                                         torch.from_numpy(cluster), pcfg)
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        je, jc = jax_router.admission_update(jnp.asarray(ema), jnp.asarray(cnt),
                                             jnp.asarray(cluster), jnp.asarray(hit),
                                             jnp.asarray(obs), jcfg)
        pe, pc = port_router.admission_update(torch.from_numpy(ema), torch.from_numpy(cnt),
                                              torch.from_numpy(cluster), torch.from_numpy(hit),
                                              torch.from_numpy(obs), pcfg)
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0, atol=1e-6)
        assert pc.dtype == torch.int32 and np.array_equal(pc.numpy(), np.asarray(jc))
        ema, cnt = np.array(je), np.array(jc)


def test_route_touch_core_ivf_matches_jax():
    """The IVF branch: query clusters, admit flags and the EMA update after
    the touch, against JAX on the same scores."""
    rng = np.random.default_rng(8)
    jcfg, pcfg = _cfgs(capacity=32, nclusters=4, policy="lru")
    js = jax_index.build_index(_filled(rng, jcfg, 30), jcfg, seed=0)
    js["adm_ema"] = jnp.asarray(np.asarray([0.1, 0.9, 0.3, 1.0], np.float32))
    js["adm_count"] = jnp.asarray(np.asarray([20, 20, 3, 40], np.int32))
    ps = _port_state(js, pcfg)
    kw = dict(tweak_threshold=0.8, admit_floor=0.5)
    rj, rp = jax_router.RouterConfig(**kw), port_router.RouterConfig(**kw)
    q = np.concatenate([np.asarray(js["emb"])[:4], _clustered(rng, 4)])
    scores, idx = jax_cache.lookup(js, jcfg, jnp.asarray(q))
    cost = np.asarray([0.5, 0.1, 0.9, 0.5, 0.5, 0.3, 0.5, 0.7], np.float32)
    jo = jax_cache.route_touch_core(js, jcfg, rj, jnp.asarray(q), scores, idx,
                                    jnp.asarray(cost))
    po = port_cache.route_touch_core(ps, pcfg, rp, torch.from_numpy(q),
                                     torch.from_numpy(np.array(scores)),
                                     torch.from_numpy(np.array(idx)), torch.from_numpy(cost))
    for a, b in zip(po[1:], jo[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not po[4].numpy().all()              # a shut cluster refused a row
    _assert_state(ps, jo[0])


def test_cache_state_converter_checks_the_layout():
    jcfg, pcfg = _cfgs(capacity=16, nclusters=2)
    js = {k: np.asarray(v) for k, v in jax_cache.init_cache(jcfg).items()}
    ps = jax_cache_state_to_torch(js, pcfg, device="cpu")
    _assert_state(ps, js)
    assert port_index.IVF_KEYS == jax_index.IVF_KEYS and set(port_index.IVF_KEYS) < set(ps)
    with pytest.raises(ValueError, match="keys"):
        jax_cache_state_to_torch({k: v for k, v in js.items() if k != "adm_ema"}, pcfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="ivf_count"):
        jax_cache_state_to_torch({**js, "ivf_count": js["ivf_count"].astype(np.int64)}, pcfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="ivf_members"):
        jax_cache_state_to_torch({**js, "ivf_members": js["ivf_members"][:, :3]}, pcfg,
                                 device="cpu")
