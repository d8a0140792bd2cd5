"""The port's row-sharded cache bank against the JAX package's LOCAL cache.

The reference claims sharded ≡ local.  Its own sharded touch fails on this
JAX version (``test_distributed.py::test_distributed_lookup_and_touch_
matches_local`` raises a ``ShardingTypeError`` in the touch scatter), so the
port's sharded functions are held to JAX's local ``lookup_route_touch``,
``make_second_stage``, ``insert_batch`` and ``insert`` on the same numpy
inputs, at 1, 2 and 4 CPU shards, flat and IVF, with and without the
cascade: the same indices, decisions, slots and admission EMA, scores
within 1e-5, and the gathered state equal to the local one.  Routing
decisions are compared on rows away from the thresholds only (asserted).
A tie straddles two shards and resolves to the lower global index; a
sparse bank returns -1 slots.  The IVF regroup is held to JAX's own
``shard_ivf_cache_state`` in a subprocess with 4 forced host devices."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RouterConfig as JaxRouterConfig
from repro.core import cache as jax_cache
from repro.core import index as jax_index
from repro.models.reranker import init_reranker as jax_init_reranker
from repro.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint import jax_cache_state_to_torch, jax_params_to_torch
from repro_torch.core import cache as port_cache
from repro_torch.core import distributed as dist
from repro_torch.core import index as port_index
from repro_torch.core import router
from repro_torch.core.engine import SharedCacheBank
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.models.reranker import tiny_reranker_config

DIM, QT, RT, VOCAB, CAP = 16, 6, 6, 512, 64
RR_CFG = tiny_reranker_config(VOCAB)
RR_JAX = jax_init_reranker(jax.random.PRNGKey(3), RR_CFG)
RR_PORT = jax_params_to_torch(_flatten(RR_JAX), RR_CFG, device="cpu")
ROUTER = dict(tweak_threshold=0.85, band=0.25, commit_at=0.65)
TIE = np.zeros(DIM, np.float32)
TIE[:4] = 0.5                         # unit norm, exact dot products
TIE_SLOTS = (5, 53)                   # shards 0 and 3 of 4, 0 and 1 of 2


def _mesh(n):
    return make_cache_mesh(n, devices=["cpu"] * n)


def _cfgs(index, **kw):
    base = dict(capacity=CAP, dim=DIM, max_query_tokens=QT, max_response_tokens=RT, topk=4,
                block_n=16, index=index)
    if index == "ivf":
        base.update(nclusters=4, nprobe=2, ivf_bucket=CAP, reindex_every=1000)
    base.update(kw)
    return jax_cache.CacheConfig(**base), port_cache.CacheConfig(**base)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows(rng, n, embs):
    qm = (np.arange(QT)[None, :] < rng.integers(2, QT + 1, n)[:, None]).astype(np.float32)
    qt = np.where(qm > 0, rng.integers(5, VOCAB, (n, QT)), 0).astype(np.int32)
    return (embs.astype(np.float32), qt, qm,
            rng.integers(5, VOCAB, (n, RT)).astype(np.int32), np.ones((n, RT), np.float32))


def _local_state(jcfg, pcfg, rng, filled, centers):
    """A JAX local state with ``filled`` rows around ``centers`` (the tie row
    planted at both ``TIE_SLOTS`` when they are filled), and its port copy."""
    embs = centers[rng.integers(0, len(centers), filled)] + 0.25 * _unit(rng, (filled, DIM))
    for s in TIE_SLOTS:
        if s < filled:
            embs[s] = TIE
    js = jax_cache.init_cache(jcfg)
    js, _ = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, _rows(rng, filled, embs)),
                                   filled)
    if jcfg.index == "ivf":
        js = jax_index.build_index(js, jcfg, seed=0)
    return js, jax_cache_state_to_torch({k: np.asarray(v) for k, v in js.items()}, pcfg,
                                        device="cpu")


def _shard(ps, pcfg, n):
    if pcfg.index == "ivf":
        return dist.shard_ivf_cache_state(ps, _mesh(n), pcfg)
    return dist.shard_cache_state(ps, _mesh(n))


def _live_pairs(state):
    """{(cluster, global slot)} of a local-layout IVF state's live entries."""
    m = state["ivf_members"]
    cid = torch.arange(m.shape[0])
    live = port_index._entry_live(m, state["ivf_count"], cid, state["valid"],
                                  state["ivf_assign"], state["ivf_pos"])
    return {(int(c), int(s)) for c, s in zip(*[t.tolist() for t in (
        cid[:, None].expand_as(m)[live], m[live])])}


def _assert_state_equal(got, js, skip=()):
    """A gathered port state against a JAX local state, key by key (IVF
    member tables by their live (cluster, slot) entries)."""
    table = {"ivf_members", "ivf_count", "ivf_pos"}
    for key, val in js.items():
        if key in skip or key in table:
            continue
        want = np.asarray(val)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[key].numpy(), want, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert np.array_equal(got[key].numpy(), want), key
    if "ivf_members" in js:
        want = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
        assert _live_pairs(got) == _live_pairs(want)


def _assert_route_equal(ps_out, js_out, tau_jax, cfg):
    """Scores within 1e-5 (-inf where JAX has -inf), finite slots' indices,
    decisions (asserted away from the thresholds), tau, cluster, admit."""
    p_scores, p_idx, p_dec, p_tau, p_cl, p_adm = [t.numpy() for t in ps_out]
    j_scores, j_idx, j_dec, _, j_cl, j_adm = [np.asarray(t) for t in js_out]
    fin = np.isfinite(j_scores)
    assert np.array_equal(np.isfinite(p_scores), fin)
    np.testing.assert_allclose(p_scores[fin], j_scores[fin], rtol=0, atol=1e-5)
    assert np.array_equal(p_idx[fin], j_idx[fin]) and (p_idx[~fin] == -1).all()
    top1 = j_scores[:, 0]
    edges = [tau_jax, tau_jax - cfg.band / 2, tau_jax + cfg.band / 2,
             np.full_like(top1, cfg.exact_threshold)]
    assert min(np.abs(top1 - e).min() for e in edges) > 5e-5
    assert np.array_equal(p_dec, j_dec)
    np.testing.assert_allclose(p_tau, np.asarray(tau_jax), rtol=0, atol=1e-7)
    assert np.array_equal(p_cl, j_cl) and np.array_equal(p_adm, j_adm)


@pytest.mark.parametrize("cascade", [False, True], ids=["band0", "band"])
@pytest.mark.parametrize("index", ["flat", "ivf"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_serve_matches_jax_local(n_shards, index, cascade):
    """Lookup + route + touch, stage 2 and the FIFO commit of every batch's
    MISS rows, over four batches: per batch the same route and slots, and
    the gathered state equal to JAX's local state at the end."""
    rng = np.random.default_rng(7)
    jcfg, pcfg = _cfgs(index)
    kw = dict(ROUTER, band=ROUTER["band"] if cascade else 0.0, admit_floor=0.3)
    jr, pr = JaxRouterConfig(**kw), router.RouterConfig(**kw)
    centers = _unit(rng, (5, DIM))
    js, ps = _local_state(jcfg, pcfg, rng, 56, centers)
    ps = _shard(ps, pcfg, n_shards)
    stage2_j = jax_cache.make_second_stage(jcfg, jr, RR_JAX, RR_CFG, donate=False)
    stage2_p = port_cache.make_second_stage(pcfg, pr, RR_PORT, RR_CFG)
    seen, tie_seen = set(), False
    for step in range(4):
        b = 8
        q = centers[rng.integers(0, 5, b)] + 0.35 * _unit(rng, (b, DIM))
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
        q[-2:] = _unit(rng, (2, DIM))                      # far from the bank: MISS
        if step == 0:
            q[0] = TIE                                     # a tie across two shards
        cost = rng.uniform(0.2, 0.8, b).astype(np.float32)
        js, *jout = jax_cache.lookup_route_touch(js, jcfg, jr, jnp.asarray(q),
                                                 jnp.asarray(cost))
        ps, *pout = dist.lookup_route_touch(ps, pcfg, pr, torch.from_numpy(q),
                                            torch.from_numpy(cost))
        j_scores, j_idx, j_dec, j_tau, j_cl, j_adm = jout
        _assert_route_equal(pout, jout, np.asarray(j_tau), jr)
        if step == 0:
            tie_seen = int(pout[1][0, 0]) == TIE_SLOTS[0] and int(pout[1][0, 1]) == TIE_SLOTS[1]
        dec = np.asarray(j_dec)
        if cascade and (dec == router.UNCERTAIN).any():
            q_t, q_m = _rows(rng, b, q)[1:3]
            j_idx_dead = jnp.where(jnp.isfinite(j_scores), j_idx, -1)
            js, jfin, jslot, jconf = stage2_j(js, jnp.asarray(q_t), jnp.asarray(q_m),
                                              j_scores, j_idx_dead, j_dec, j_tau, j_cl)
            ps, pfin, pslot, pconf = stage2_p(ps, torch.from_numpy(q_t).long(),
                                              torch.from_numpy(q_m), *pout[:5])
            assert np.array_equal(pfin.numpy(), np.asarray(jfin))
            assert np.array_equal(pslot.numpy(), np.asarray(jslot))
            np.testing.assert_allclose(pconf.numpy(), np.asarray(jconf), rtol=0, atol=1e-6)
            dec = np.asarray(jfin)
            seen.add("stage2")
        seen |= set(dec.tolist())
        miss = np.flatnonzero((dec == router.MISS) & np.asarray(j_adm))
        if miss.size:
            rows = _rows(rng, 8, np.concatenate([q[miss], np.zeros((8 - miss.size, DIM),
                                                                   np.float32)]))
            js, jslots = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, rows), miss.size)
            ps, pslots = dist.insert_batch(ps, pcfg, *map(torch.from_numpy, rows), miss.size)
            assert np.array_equal(pslots.numpy(), np.asarray(jslots))
    assert tie_seen
    assert {router.MISS, router.TWEAK, router.EXACT} <= seen
    assert ("stage2" in seen) == cascade
    _assert_state_equal(dist.gather_cache_state(ps, pcfg), js)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sparse_bank_slots_and_empty_shards(n_shards):
    """Fewer valid rows than k: the merged top-k ends in (-inf, -1) slots,
    shards with no valid row contribute none, equal to the local lookup."""
    rng = np.random.default_rng(3)
    jcfg, pcfg = _cfgs("flat")
    _, ps = _local_state(jcfg, pcfg, rng, 3, _unit(rng, (2, DIM)))
    q = torch.from_numpy(_unit(rng, (5, DIM)))
    want_s, want_i = port_cache.lookup(ps, pcfg, q)
    got_s, got_i = dist.lookup(_shard(ps, pcfg, n_shards), pcfg, q)
    assert torch.equal(got_i, want_i) and (got_i[:, 3] == -1).all()
    assert torch.equal(torch.isinf(got_s), torch.isinf(want_s))
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=0, atol=1e-6)


def test_merge_ties_go_to_the_lowest_global_index():
    """Equal scores across shards, in any shard order of the input, and
    empty slots: the merge keeps (score desc, global index asc), -1 last."""
    s = torch.tensor([[0.9, 0.5, -torch.inf], [0.7, 0.7, 0.1]])
    parts = [(s[:, :2], torch.tensor([[3, 9], [1, 2]], dtype=torch.int32)),
             (torch.tensor([[0.9, -torch.inf], [0.7, 0.2]]),
              torch.tensor([[20, -1], [17, 30]], dtype=torch.int32))]
    top_s, top_i = dist.merge_shard_topk(parts, 4, torch.device("cpu"))
    assert top_i.tolist() == [[3, 20, 9, -1], [1, 2, 17, 30]]
    assert top_s[0, 3] == -torch.inf


@pytest.mark.parametrize("index", ["flat", "ivf"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_insert_batch_laps_the_ring(n_shards, index):
    """A batch longer than the bank (only its last ``capacity`` rows stay)
    and a padded batch, from a pointer mid-ring: slots, the gathered state,
    ``ivf_pending`` and ``ivf_overflow`` equal JAX's local insert_batch."""
    rng = np.random.default_rng(11)
    jcfg, pcfg = _cfgs(index)
    js, ps = _local_state(jcfg, pcfg, rng, 21, _unit(rng, (4, DIM)))
    ps = _shard(ps, pcfg, n_shards)
    for b, count in ((96, 80), (16, 9), (16, 16)):
        rows = _rows(rng, b, _unit(rng, (b, DIM)))
        js, jslots = jax_cache.insert_batch(js, jcfg, *map(jnp.asarray, rows), count)
        ps, pslots = dist.insert_batch(ps, pcfg, *map(torch.from_numpy, rows), count)
        assert np.array_equal(pslots.numpy(), np.asarray(jslots))
        assert ps["ring"] == int(ps["ptr"]) == int(js["ptr"])
    _assert_state_equal(dist.gather_cache_state(ps, pcfg), js)


@pytest.mark.parametrize("policy", ["fifo", "lru", "lfu"])
def test_sharded_single_insert_matches_jax_insert(policy):
    """Held to the reference's own single-row ``insert`` through touches
    that reorder the LRU/LFU victims across shards."""
    rng = np.random.default_rng(4)
    jcfg, pcfg = _cfgs("flat", capacity=16, policy=policy)
    js = jax_cache.init_cache(jcfg)
    ps = dist.shard_cache_state(port_cache.init_cache(pcfg, "cpu"), _mesh(4))
    ins = dist.make_distributed_insert(_mesh(4), pcfg)
    for i in range(22):
        row = [a[0] for a in _rows(rng, 1, rng.standard_normal((1, DIM)))]
        js = jax_cache.insert(js, jcfg, *map(jnp.asarray, row))
        ps = ins(ps, *map(torch.from_numpy, row))
        if i % 3 == 0:
            hit = np.asarray([i % 16, (3 * i) % 16], np.int32)
            js = jax_cache.touch(js, jcfg, jnp.asarray(hit))
            ps = port_cache._touch_rows(ps, pcfg, torch.from_numpy(hit),
                                        torch.ones(2, dtype=torch.bool))
    _assert_state_equal(dist.gather_cache_state(ps, pcfg), js)


def test_shard_gather_round_trip_and_guards():
    rng = np.random.default_rng(5)
    for index in ("flat", "ivf"):
        jcfg, pcfg = _cfgs(index)
        js, ps = _local_state(jcfg, pcfg, rng, 40, _unit(rng, (4, DIM)))
        back = dist.gather_cache_state(_shard(ps, pcfg, 4), pcfg)
        assert set(back) == set(ps)
        for key in ps:
            assert torch.equal(back[key], ps[key]), (index, key)
    # FIFO only, as the reference asserts; IVF banks take no single insert
    with pytest.raises(ValueError, match="FIFO"):
        dist.make_distributed_insert_batch(_mesh(2), _cfgs("flat", policy="lru")[1])
    with pytest.raises(ValueError, match="IVF"):
        dist.make_distributed_insert(_mesh(2), _cfgs("ivf")[1])
    with pytest.raises(ValueError, match="split"):
        dist.shard_cache_state(port_cache.init_cache(_cfgs("flat")[1], "cpu"), _mesh(3))
    with pytest.raises(ValueError, match="shard_ivf"):
        dist.shard_cache_state(ps, _mesh(2))
    # an overflowed IVF table must be rebuilt before it is sharded
    _, pcfg = _cfgs("ivf", capacity=8, nclusters=2, ivf_bucket=4)
    state = port_cache.init_cache(pcfg, "cpu")
    for _ in range(2):          # stale entries of the first pass fill the table
        rows = _rows(rng, 8, _unit(rng, (8, DIM)))
        state, _ = port_cache.insert_batch(state, pcfg, *map(torch.from_numpy, rows), 8)
    assert bool(state["ivf_overflow"])
    with pytest.raises(ValueError, match="overflow"):
        dist.shard_ivf_cache_state(state, _mesh(2), pcfg)


def test_make_cache_mesh():
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="4 CUDA devices"):
            make_cache_mesh(4)
    assert make_cache_mesh(3, devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="2 devices for 4 shards"):
        make_cache_mesh(4, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_cache_mesh(0)


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_sharded_bank_matches_local_bank_through_reindex(index):
    """``SharedCacheBank(mesh=)`` against a local bank of the port on the
    same commits: routes equal, and an IVF bank's sharded recluster (gather,
    ``build_index``, reshard) leaves the same index as the local one."""
    rng = np.random.default_rng(9)
    _, pcfg = _cfgs(index, reindex_every=64) if index == "ivf" else _cfgs(index)
    rcfg = router.RouterConfig(tweak_threshold=0.85, admit_floor=0.3)
    local = SharedCacheBank(pcfg, rcfg, device="cpu")
    sharded = SharedCacheBank(pcfg, rcfg, mesh=_mesh(4))
    assert sharded.sharded and not local.sharded
    centers = _unit(rng, (4, DIM))
    rebuilt = []
    for step in range(6):
        q = centers[rng.integers(0, 4, 16)] + 0.3 * _unit(rng, (16, DIM))
        q = torch.from_numpy((q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32))
        lo = local.route_batch(q)
        sh = sharded.route_batch(q)
        for a, b in zip(lo, sh):
            assert torch.equal(a, b) if a.dtype != torch.float32 else torch.allclose(
                a, b, atol=1e-6)
        rows = [torch.from_numpy(a) for a in _rows(rng, 16, q.numpy())]
        assert torch.equal(local.insert_batch(*rows, 16), sharded.insert_batch(*rows, 16))
        rebuilt.append((local.maybe_reindex(), sharded.maybe_reindex()))
    assert all(a == b for a, b in rebuilt)
    if index == "ivf":
        assert any(a for a, _ in rebuilt)
    got = dist.gather_cache_state(sharded.state, pcfg)
    for key, val in local.state.items():
        if key in ("ivf_members", "ivf_count", "ivf_pos"):
            continue
        assert torch.allclose(got[key].float(), val.float(), atol=1e-6), key
    if index == "ivf":
        assert _live_pairs(got) == _live_pairs(local.state)


_REGROUP_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core import cache as cache_lib, index as index_lib
    from repro.core.distributed import shard_ivf_cache_state

    cfg = cache_lib.CacheConfig(capacity=64, dim=16, max_query_tokens=6,
                                max_response_tokens=6, topk=4, index="ivf", nclusters=4)
    rng = np.random.default_rng(2)
    embs = rng.standard_normal((48, 16)).astype(np.float32)
    z = lambda w, dt: jnp.ones((48, w), dt)
    state = cache_lib.init_cache(cfg)
    state, _ = cache_lib.insert_batch(state, cfg, jnp.asarray(embs), z(6, jnp.int32),
                                      z(6, jnp.float32), z(6, jnp.int32), z(6, jnp.float32), 48)
    state = index_lib.build_index(state, cfg, seed=0)
    more = rng.standard_normal((8, 16)).astype(np.float32)
    z = lambda w, dt: jnp.ones((8, w), dt)
    state, _ = cache_lib.insert_batch(state, cfg, jnp.asarray(more), z(6, jnp.int32),
                                      z(6, jnp.float32), z(6, jnp.int32), z(6, jnp.float32), 8)
    local = {k: np.asarray(v).tolist() for k, v in state.items()}
    mesh = jax.make_mesh((4,), ("data",))
    sh = shard_ivf_cache_state(state, mesh, cfg)
    out = {k: np.asarray(sh[k]).tolist() for k in ("ivf_members", "ivf_count", "ivf_pos")}
    print(json.dumps({"local": local, "sharded": out, "n_dev": len(jax.devices())}))
""")


def test_ivf_regroup_matches_jax_shard_ivf_cache_state():
    """A JAX IVF state (built, then filed into) converted by
    ``jax_cache_state_to_torch`` and sharded by the port gives JAX's own
    ``shard_ivf_cache_state`` member tables, counts and positions."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REGROUP_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert res["n_dev"] == 4
    _, pcfg = _cfgs("ivf", nclusters=4, nprobe=8, ivf_bucket=0, reindex_every=0)
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}
    local = {k: np.asarray(res["local"][k], dtype=np_dtype[v.dtype])
             for k, v in port_cache.init_cache(pcfg, "meta").items()}
    ps = jax_cache_state_to_torch(local, pcfg, device="cpu")
    sh = dist.shard_ivf_cache_state(ps, _mesh(4), pcfg)
    members = np.concatenate([s["ivf_members"].numpy() for s in sh["shards"]])
    count = np.concatenate([s["ivf_count"].numpy() for s in sh["shards"]])
    pos = np.concatenate([s["ivf_pos"].numpy() for s in sh["shards"]])
    want = res["sharded"]
    assert np.array_equal(members, np.asarray(want["ivf_members"]))
    assert np.array_equal(count, np.asarray(want["ivf_count"]))
    assert np.array_equal(pos, np.asarray(want["ivf_pos"]))
    assert (count > 0).sum() > 4                  # rows spread over shards and clusters
