"""Port kernels: each plain PyTorch version against the JAX package's
``ref.py`` and its Pallas kernel (interpret mode on the CPU), within 2e-5
as in tests/test_kernels.py.  The Hopper kernels against these plain
versions are in tests/test_torch_cuda.py."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cosine_topk.ops import cosine_topk as jax_cosine_topk
from repro.kernels.cosine_topk.ops import cosine_topk_gather as jax_gather
from repro.kernels.cosine_topk.ref import cosine_topk_gather_ref as jax_gather_ref
from repro.kernels.cosine_topk.ref import cosine_topk_ref as jax_cosine_ref
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_block_ref as jax_block_ref
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import build
from repro_torch.kernels.cosine_topk import ops as cos_ops
from repro_torch.kernels.cosine_topk.ref import cosine_topk_gather_ref, cosine_topk_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_block_ref,
                                                      decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attend_blockwise, attend_naive
from repro_torch.kernels.paged_attention import ops as paged_ops

TOL = 2e-5


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _assert_topk(s_port, i_port, s_ref, i_ref):
    """Scores within TOL; indices equal on finite slots whose score is at
    least TOL away from its neighbours (ties may order either way)."""
    s_port, s_ref = np.asarray(s_port), np.asarray(s_ref)
    i_port, i_ref = np.asarray(i_port), np.asarray(i_ref)
    np.testing.assert_allclose(s_port, s_ref, rtol=TOL, atol=TOL)
    fin = np.isfinite(s_ref)
    assert np.array_equal(np.isfinite(s_port), fin)
    gap = np.full(s_ref.shape, np.inf)
    d = np.abs(np.diff(np.where(fin, s_ref, 1e9), axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sure = fin & (gap > TOL)
    assert np.array_equal(i_port[sure], i_ref[sure])


# ------------------------------------------------------------ cosine_topk

@pytest.mark.parametrize("b,n,d,k,bn,p_valid", [
    (1, 128, 16, 1, 64, 0.85), (4, 256, 64, 4, 64, 0.85),
    (2, 512, 384, 8, 128, 0.5), (8, 1024, 128, 4, 512, 1.0),
    (3, 64, 32, 4, 64, 0.03),   # fewer valid rows than k: sub-k slots
])
def test_cosine_topk_plain_matches_jax(b, n, d, k, bn, p_valid):
    rng = np.random.default_rng(b * n + k)
    q, db = _unit(rng, (b, d)), _unit(rng, (n, d))
    valid = rng.random(n) < p_valid
    s, i = cosine_topk_ref(torch.from_numpy(q), torch.from_numpy(db), k,
                           torch.from_numpy(valid))
    s_ref, i_ref = jax_cosine_ref(jnp.asarray(q), jnp.asarray(db), k, jnp.asarray(valid))
    _assert_topk(s, i, s_ref, i_ref)
    s_pl, i_pl = jax_cosine_topk(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid),
                                 k=k, impl="pallas", block_n=bn)
    _assert_topk(s, i, s_pl, i_pl)
    # sub-k slots: -inf with index -1, the Pallas path's semantics
    n_valid = int(valid.sum())
    if n_valid < k:
        assert np.all(np.isneginf(s.numpy()[:, n_valid:]))
        assert np.all(i.numpy()[:, n_valid:] == -1)
        assert np.array_equal(i.numpy(), np.asarray(i_pl))


def test_cosine_topk_ties_go_to_lowest_index():
    rng = np.random.default_rng(0)
    base = _unit(rng, (4, 32))
    db = np.concatenate([base, base, base])            # rows i, i+4, i+8 tie
    q = base[[2, 0]]
    valid = np.ones(12, bool)
    valid[2] = False                                   # the first copy of row 2 is dead
    s, i = cosine_topk_ref(torch.from_numpy(q), torch.from_numpy(db), 3,
                           torch.from_numpy(valid))
    assert i.tolist() == [[6, 10, int(i[0, 2])], [0, 4, 8]]
    _, i_ref = jax_cosine_ref(jnp.asarray(q), jnp.asarray(db), 3, jnp.asarray(valid))
    assert np.array_equal(i.numpy()[:, :2], np.asarray(i_ref)[:, :2])
    assert s.dtype == torch.float32 and i.dtype == torch.int32


def test_cosine_topk_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q, db = torch.from_numpy(_unit(rng, (2, 64))), torch.from_numpy(_unit(rng, (256, 64)))
    valid = torch.ones(256, dtype=torch.bool)
    before = cos_ops.launches
    s, i = cos_ops.cosine_topk(q, db, valid, k=4)
    s2, i2 = cosine_topk_ref(q, db, 4, valid)
    assert torch.equal(s, s2) and torch.equal(i, i2)
    assert cos_ops.launches == before          # a launch counts only on the card


# ------------------------------------------------------------ cosine_topk_gather

def _shortlist(rng, b, n, m, d, p_live):
    """Queries, a bank, per-query candidate rows (some -1 padding, repeats
    likely) and a validity mask."""
    q, db = _unit(rng, (b, d)), _unit(rng, (n, d))
    idx = rng.integers(0, n, (b, m)).astype(np.int32)
    idx[rng.random((b, m)) < 0.15] = -1
    return q, db, idx, rng.random((b, m)) < p_live


@pytest.mark.parametrize("b,n,m,d,k,bm,p_live", [
    (1, 64, 16, 16, 1, 8, 0.9), (4, 256, 96, 64, 4, 32, 0.5),
    (2, 512, 200, 384, 8, 64, 0.6),    # M not a multiple of the block
    (3, 128, 40, 32, 4, 16, 0.06),     # fewer live candidates than k
])
def test_cosine_topk_gather_plain_matches_jax(b, n, m, d, k, bm, p_live):
    rng = np.random.default_rng(b * m + k)
    q, db, idx, valid = _shortlist(rng, b, n, m, d, p_live)
    live = valid & (idx >= 0)
    cand = db[np.clip(idx, 0, None)]
    s, i = cosine_topk_gather_ref(*map(torch.from_numpy, (q, cand, idx, live)), k)
    s_ref, i_ref = jax_gather_ref(*map(jnp.asarray, (q, cand, idx, live)), k)
    _assert_topk(s, i, s_ref, i_ref)
    s_pl, i_pl = jax_gather(*map(jnp.asarray, (q, db, idx, valid)), k=k, impl="pallas",
                            block_m=bm)
    _assert_topk(s, i, s_pl, i_pl)
    n_live = live.sum(axis=1)
    for row in np.flatnonzero(n_live < k):      # sub-k slots: (-inf, -1), as Pallas
        assert np.all(np.isneginf(s.numpy()[row, n_live[row]:]))
        assert np.all(i.numpy()[row, n_live[row]:] == -1)
        assert np.array_equal(i.numpy()[row], np.asarray(i_pl)[row])


def test_cosine_topk_gather_ties_duplicates_padding_and_dead_rows():
    """Ties go to the lowest candidate position, a row listed twice is
    reported twice, padding and dead candidates never surface, and a query
    with no live candidate gets (-inf, -1) everywhere."""
    rng = np.random.default_rng(3)
    db = _unit(rng, (6, 32))
    db[4] = db[1]                                      # rows 1 and 4 tie for db[1]
    q = db[[1, 1, 2]]
    idx = np.asarray([[4, 3, 1, 1, -1, 1],             # 4 before 1, 1 twice
                      [1, 3, 4, -1, 4, 0],             # 1 before 4
                      [2, 2, -1, 5, 0, 1]], np.int32)  # every candidate dead
    valid = np.ones(idx.shape, bool)
    valid[0, 5] = False
    valid[2] = False
    k = 4
    s, i = cos_ops.cosine_topk_gather(*map(torch.from_numpy, (q, db, idx, valid)), k=k)
    assert i[0, :3].tolist() == [4, 1, 1] and i[1, :3].tolist() == [1, 4, 4]
    assert torch.all(s[:2, :3] > 0.9999)
    assert i[2].tolist() == [-1] * k and torch.all(torch.isneginf(s[2]))
    for impl in ("xla", "pallas"):
        s_j, i_j = jax_gather(*map(jnp.asarray, (q, db, idx, valid)), k=k, impl=impl,
                              block_m=2)
        assert np.array_equal(i.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=TOL, atol=TOL)
    assert s.dtype == torch.float32 and i.dtype == torch.int32


def test_cosine_topk_gather_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    q, db, idx, valid = map(torch.from_numpy, _shortlist(rng, 2, 128, 48, 64, 0.5))
    before = cos_ops.gather_launches
    s, i = cos_ops.cosine_topk_gather(q, db, idx, valid, k=4)
    live = valid & (idx >= 0)
    s2, i2 = cosine_topk_gather_ref(q, db[idx.clamp(min=0).long()], idx, live, 4)
    assert torch.equal(s, s2) and torch.equal(i, i2)
    assert cos_ops.gather_launches == before   # a launch counts only on the card


@pytest.mark.parametrize("b,m,d,k,block_m", [
    (8, 2048, 384, 4, 64),      # ivf-probe: 8 x 256
    (8, 8192, 384, 4, 64),      # ivf-probe-1m: 8 x 1,024
    (8, 2048, 384, 8, 64),
    (3, 200, 64, 8, 64),        # M not a multiple of the block
    (5, 96, 128, 1, 32),
    (4, 40, 384, 4, 64),        # M below one block
    (2, 7, 32, 4, 64),          # ... and not a multiple of 4
    (1, 1, 16, 1, 64),
    (3, 20000, 1024, 4, 64),    # three rounds a block, three passes a row
    (40, 8192, 384, 8, 64),     # more queries than one wave of clusters of 8
])
def test_gather_plan_covers_every_position_once(b, m, d, k, block_m):
    """The blocks of a query tile its positions [0, M) once in ascending
    order, each block at least min(block_m, M) positions and a multiple of 4
    (the last one ragged); the blocks of a query are one cluster of at most
    MAX_CLUSTER, which divides the grid; the shared memory fits a block."""
    plan = cos_ops.gather_plan(b, m, d, k, block_m)
    pos = [p for lo, hi in plan.blocks for p in range(lo, hi)]
    assert pos == list(range(m))
    assert all(hi > lo for lo, hi in plan.blocks)
    assert plan.block_m % 4 == 0 and plan.block_m >= min(block_m, m)
    assert all(hi - lo == plan.block_m for lo, hi in plan.blocks[:-1])
    assert plan.grid == (len(plan.blocks), b) and plan.cluster == plan.grid[0]
    assert 1 <= plan.cluster <= min(cos_ops.MAX_CLUSTER, len(cos_ops.GATHER_WAVE_CLUSTERS))
    assert plan.grid[0] % plan.cluster == 0
    assert plan.rounds == -(-plan.block_m // cos_ops.GATHER_ROUND)
    assert plan.row_passes == -(-d // cos_ops.GATHER_ROW_FLOATS)
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK
    assert plan.rows_in_flight == cos_ops.GATHER_WARPS * cos_ops.GATHER_ROWS
    if b <= cos_ops.GATHER_WAVE_CLUSTERS[-1]:     # one wave: every query its own cluster
        assert b <= cos_ops.GATHER_WAVE_CLUSTERS[plan.cluster - 1]


@pytest.mark.parametrize("m,block_m", [(2048, 256), (8192, 1024)])
def test_gather_plan_at_the_main_shapes(m, block_m):
    """The IVF probe at B 8, D 384 (ivf-probe and ivf-probe-1m): 8 clusters
    of 8 blocks, one round of positions a block, one pass over a row, 64
    rows in flight a block, one wave; 8,872 bytes of static shared memory
    at k 4."""
    plan = cos_ops.gather_plan(8, m, 384, 4)
    assert (plan.grid, plan.cluster, plan.block_m) == ((8, 8), 8, block_m)
    assert plan.rounds == 1 and plan.row_passes == 1 and plan.rows_in_flight == 64
    assert plan.smem_bytes == 8_872
    assert 8 <= cos_ops.GATHER_WAVE_CLUSTERS[7]


# ------------------------------------------------------------ decode

@pytest.mark.parametrize("b,h,hk,t,dh", [(1, 4, 4, 128, 64), (2, 8, 2, 300, 32),
                                         (3, 4, 1, 64, 128), (2, 32, 8, 160, 16)])
def test_decode_attention_plain_matches_jax(b, h, hk, t, dh):
    rng = np.random.default_rng(t + h)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    out = decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    args = [jnp.asarray(a) for a in (q, k, v, lens)]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_decode_ref(*args)),
                               rtol=TOL, atol=TOL)
    pallas = jax_decode(*args, block_t=64, impl="pallas")
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)
    via_ops = dec_ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert torch.equal(via_ops, out)


def test_decode_split_plan_covers_cache():
    for b, hk, t in [(8, 8, 97), (8, 8, 300), (1, 1, 5000), (64, 8, 33)]:
        chunk, nsplit = dec_ops.split_plan(b, hk, t)
        assert chunk * nsplit >= t > chunk * (nsplit - 1)
        assert chunk >= min(t, dec_ops.MIN_CHUNK)


# ------------------------------------------------------------ flash

def _qkv(rng, b, sq, sk, h, hk, dh):
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hk, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hk, dh)).astype(np.float32))


@pytest.mark.parametrize("b,p,s,h,hk,dh,bq,bk,window", [
    (2, 45, 16, 4, 2, 16, 32, 32, 0),   # TWEAK suffix over a 45-token prefix
    (1, 0, 70, 8, 2, 32, 32, 64, 0),    # plain prefill, ragged blocks
    (2, 7, 40, 4, 4, 16, 16, 16, 9),    # sliding window
])
def test_flash_with_positions_matches_xla_flash(b, p, s, h, hk, dh, bq, bk, window):
    """The port's blockwise plain version against ``_attend_xla_flash`` for
    queries at positions [P, P+S) over keys [prefix | suffix]."""
    rng = np.random.default_rng(p + s)
    q, k, v = _qkv(rng, b, s, p + s, h, hk, dh)
    q_pos = np.broadcast_to(np.arange(p, p + s, dtype=np.int32), (b, s)).copy()
    k_pos = np.broadcast_to(np.arange(p + s, dtype=np.int32), (b, p + s)).copy()
    ref = jax_attn._attend_xla_flash(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                                     True, window, bq, bk)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    out = attend_blockwise(*t, True, window, bq, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    via_ops = flash_ops.flash_attention(*t, causal=True, window=window, block_q=bq,
                                        block_k=bk, impl="xla_flash")
    assert torch.equal(via_ops, out)
    naive = attend_naive(*t, True, window)
    ref_naive = jax_attn._attend_naive(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                                       True, window)
    np.testing.assert_allclose(naive.numpy(), np.asarray(ref_naive), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_flash_plain_matches_jax_ref_and_pallas(causal, window):
    """Positions from 0: the Pallas kernel's own setting."""
    rng = np.random.default_rng(3)
    b, s, h, hk, dh = 2, 64, 4, 2, 32
    q, k, v = _qkv(rng, b, s, s, h, hk, dh)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    out = attend_blockwise(*t, causal, window, 32, 32)
    ref = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=window, block_q=32, block_k=32, impl="pallas")
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)


def test_blockwise_is_length_invariant():
    """Appending fully masked key blocks leaves the output bit for bit."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 16, 40, 4, 2, 16)
    q_pos = torch.arange(24, 40, dtype=torch.int32)[None]
    k_pos = torch.arange(40, dtype=torch.int32)[None]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    a = attend_blockwise(*t, q_pos, k_pos, True, 0, 16, 16)
    k2 = torch.cat([t[1], torch.randn(1, 50, 2, 16)], dim=1)
    v2 = torch.cat([t[2], torch.randn(1, 50, 2, 16)], dim=1)
    kp2 = torch.cat([k_pos, torch.full((1, 50), 2 ** 30, dtype=torch.int32)], dim=1)
    b2 = attend_blockwise(t[0], k2, v2, q_pos, kp2, True, 0, 16, 16)
    assert torch.equal(a, b2)


# ------------------------------------------------------------ launch plans

@pytest.mark.parametrize("b,sq,sk,h,hk,dh,dtype,impl,block", [
    (8, 128, 173, 32, 8, 128, torch.bfloat16, "xla_flash", 64),   # TWEAK suffix, llama
    (8, 64, 64, 32, 8, 128, torch.bfloat16, "naive", 128),        # MISS prefill, llama
    (3, 37, 37, 4, 4, 64, torch.bfloat16, "naive", 32),           # g 1, ragged
    (2, 50, 60, 8, 4, 64, torch.bfloat16, "xla_flash", 16),       # g 2
    (1, 5, 5, 8, 1, 128, torch.bfloat16, "naive", 64),            # g 8, fewer rows than a tile
    (3, 37, 37, 4, 4, 64, torch.float32, "naive", 32),            # fp32 body
    (8, 128, 173, 32, 8, 128, torch.float32, "xla_flash", 64),
])
def test_flash_launch_plan_covers_every_row_once(b, sq, sk, h, hk, dh, dtype, impl, block):
    """Every (b, query, head) output row belongs to exactly one block; a
    tensor-core block holds (query, head) pairs of one KV group only, so its
    K/V tiles serve all its rows; shared memory fits a block."""
    plan = flash_ops.launch_plan(b, sq, sk, h, hk, dh, dtype, impl, block)
    assert plan.route == ("mma" if dtype == torch.bfloat16 else "simt")
    seen = Counter()
    gx, gy, gz = plan.grid
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                rows = flash_ops.block_rows(plan, (x, y, z), sq)
                assert rows, "a block with no row"
                seen.update(rows)
                if plan.route == "mma":
                    assert len(rows) <= flash_ops.M_TILE
                    assert {head // (h // hk) for _, _, head in rows} == {y}
    assert set(seen) == {(i, qi, hh) for i in range(b) for qi in range(sq) for hh in range(h)}
    assert max(seen.values()) == 1
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("sk,impl,block", [(173, "xla_flash", 64), (64, "naive", 128),
                                           (173, "naive", 64), (1000, "xla_flash", 512)])
def test_flash_key_tiles_depend_on_the_keys_alone(sk, impl, block):
    """The key-tile schedule is a function of Sk_pad only (tiles of 64
    counted from key 0), so a suffix over a stored prefix and the inline
    prefill of the whole prompt walk the same tiles."""
    plans = [flash_ops.launch_plan(8, sq, sk, 32, 8, 128, torch.bfloat16, impl, block)
             for sq in (1, 37, 128, sk)]
    assert all(p.key_tiles == plans[0].key_tiles and p.sk_pad == plans[0].sk_pad
               for p in plans)
    tiles, sk_pad = plans[0].key_tiles, plans[0].sk_pad
    assert sk_pad == (sk if impl == "naive" else -(-sk // block) * block)
    assert tiles[0][0] == 0 and tiles[-1][1] == sk_pad
    assert all(a[1] == c[0] for a, c in zip(tiles, tiles[1:]))
    assert all(lo % flash_ops.KEY_TILE == 0 and hi - lo <= flash_ops.KEY_TILE
               for lo, hi in tiles)


def test_flash_plan_shared_memory():
    """Two tensor-core blocks share an SM at the main-path shapes (82,448
    bytes each at dh 128), and one block fits up to Sk 131,072."""
    main = flash_ops.launch_plan(8, 128, 173, 32, 8, 128, torch.bfloat16, "xla_flash", 64)
    assert main.smem_bytes == 82_448 and 2 * main.smem_bytes <= 228 * 1024 - 2 * 1024
    for dh in (64, 128):
        for sk in (1, 173, 4096, 131_072):
            plan = flash_ops.launch_plan(1, 16, sk, 8, 2, dh, torch.bfloat16, "naive", 64)
            assert plan.smem_bytes <= build.SMEM_PER_BLOCK
    assert flash_ops.launch_plan(1, 16, 173, 8, 2, 128, torch.float32, "naive",
                                 64).smem_bytes == 0


@pytest.mark.parametrize("b,kq,cap,hk,g,dh,dtype", [
    (8, 1, 206, 8, 4, 128, torch.bfloat16),    # llama-3.1-8b paged decode
    (8, 4, 206, 8, 4, 128, torch.bfloat16),    # its verify block, K 4
    (3, 3, 75, 2, 4, 64, torch.bfloat16),      # K 3: a panel short of its n-tiles
    (2, 4, 45, 8, 8, 64, torch.bfloat16),      # G 8: two panels of 2 queries
    (3, 3, 700, 1, 8, 128, torch.bfloat16),    # G 8, K 3: panels of 2 and 1
    (1, 2, 4096, 8, 1, 128, torch.bfloat16),   # G 1, long cache: splits of 2 tiles
    (64, 1, 100, 8, 2, 128, torch.bfloat16),   # many rows: one split, no merge
    (8, 4, 206, 8, 4, 128, torch.float32),     # fp32: the panel body
    (3, 3, 75, 2, 8, 64, torch.float32),
])
def test_paged_launch_plan_covers_every_slot_and_row_once(b, kq, cap, hk, g, dh, dtype):
    """Every slot of a row falls in exactly one (split, tile), every
    (query, head) row of a KV head in exactly one panel; tensor-core tiles
    are 64 slots counted from slot 0; two blocks share an SM.  (The plan is
    the one of the dense kernels too, with T as cap; it does not depend on
    the page size.)"""
    plan = dec_ops.launch_plan(b, kq, cap, hk, g, dh, dtype)
    mma = dtype == torch.bfloat16
    assert plan.route == ("mma" if mma else "panel")
    gx, gy, gz = plan.grid
    assert gx == b * hk and gy == plan.splits
    tiles = [plan.tiles(split, cap) for split in range(gy)]
    assert all(tiles), "a split with no slot"
    slots = Counter(s for ts in tiles for lo, hi in ts for s in range(lo, hi))
    assert set(slots) == set(range(cap)) and max(slots.values()) == 1
    if mma:
        assert plan.tile == dec_ops.TILE and plan.chunk % dec_ops.TILE == 0
        assert all(lo % dec_ops.TILE == 0 for ts in tiles for lo, _ in ts)
        assert plan.splits <= dec_ops.MAX_SPLITS
    else:   # the panel instances the kernel has: 1, 2 or 4 queries
        assert plan.kq_panel in (1, 2, 4)
    rows = Counter((qi, gi) for z in range(gz) for qi in plan.panel_queries(z, kq)
                   for gi in range(g))
    assert set(rows) == {(qi, gi) for qi in range(kq) for gi in range(g)}
    assert max(rows.values()) == 1
    assert all(0 < len(plan.panel_queries(z, kq)) * g
               <= (dec_ops.MAX_COLS if mma else dec_ops.PANEL_ROWS) for z in range(gz))
    assert 2 * plan.smem_bytes <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("kq", [1, 4])
def test_paged_plan_at_the_main_shapes(kq):
    """B 8 x Hk 8 at cap 206 (4 tiles): 4 splits would make 64 clusters of
    4, over the 62 an H100 holds at once, so 2 splits of two 64-slot tiles,
    128 blocks in one wave, merged in the kernel; 71,184 bytes of dynamic
    shared memory at dh 128."""
    plan = dec_ops.launch_plan(8, kq, 206, 8, 4, 128, torch.bfloat16)
    assert plan.grid == (64, 2, 1) and plan.chunk == 128 and plan.kq_panel == kq
    assert plan.grid[0] * plan.grid[2] <= dec_ops.WAVE_CLUSTERS[plan.splits - 1]
    assert plan.smem_bytes == 71_184
    for cap in (1, 206, 4096, 131_072):
        for dh in (64, 128):
            big = dec_ops.launch_plan(1, 4, cap, 1, 1, dh, torch.bfloat16)
            assert 2 * big.smem_bytes <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("t", [45, 97, 206, 300, 4096])
def test_launch_plan_covers_every_slot_and_row_once(t, kq, dtype):
    """The one plan of the dense and the paged kernels, at the cache widths
    the tests and the main path use (T or cap): every slot of [0, T) in one
    (split, tile) and every (query, head) row in one panel, as the paged
    kernels walk it; the dense kernels, which stop each split at the last
    query's limit, load the visible slots [0, end) once, in the paged walk's
    tiles cut at ``end`` (so a dense and a paged cache holding the same rows
    at cap == T are summed tile for tile alike)."""
    b, hk, g, dh = 8, 8, 4, 128
    plan = dec_ops.launch_plan(b, kq, t, hk, g, dh, dtype)
    assert plan.route == ("mma" if dtype == torch.bfloat16 else "panel")
    gx, gy, gz = plan.grid
    assert (gx, gy) == (b * hk, plan.splits)
    paged = [plan.tiles(split, t) for split in range(gy)]
    slots = Counter(s for ts in paged for lo, hi in ts for s in range(lo, hi))
    assert set(slots) == set(range(t)) and max(slots.values()) == 1
    rows = Counter((qi, gi) for z in range(gz) for qi in plan.panel_queries(z, kq)
                   for gi in range(g))
    assert set(rows) == {(qi, gi) for qi in range(kq) for gi in range(g)}
    assert max(rows.values()) == 1
    rng = np.random.default_rng(t + kq)
    for cache_len in {0, t - kq, *rng.integers(0, t - kq + 1, size=4).tolist()}:
        end = min(t, cache_len + kq)       # the block's; decode: cache_len = pos + 1
        # the dense kernels stop each split at end: s1 = min(s0 + chunk, DenseKV::end)
        dense = [plan.tiles(split, end) for split in range(gy)]
        seen = [s for ts in dense for lo, hi in ts for s in range(lo, hi)]
        assert sorted(seen) == list(range(end))
        cut = [[(lo, min(hi, end)) for lo, hi in ts if lo < end] for ts in paged]
        assert dense == cut
    if plan.route == "mma":    # the clusters fit in one wave (or there is one split)
        assert plan.splits == 1 or gx * gz <= dec_ops.WAVE_CLUSTERS[plan.splits - 1]
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("t,kq,chunk,nt", [(206, 1, 128, 1), (206, 4, 128, 2), (97, 1, 64, 1)])
def test_dense_plan_at_the_main_shapes(t, kq, chunk, nt):
    """llama-3.1-8b (B 8, H 32 / Hk 8, dh 128) in bf16: TWEAK decode and
    verify at T 206 (4 tiles) and MISS decode at T 97 (2 tiles) cut into 2
    splits (8 x 8 x 2 = 128 blocks, one launch, one wave; 4 splits would make
    64 clusters of 4, over the 62 an H100 holds at once); K 4 at G 4 is one
    panel of 16 (query, head) rows, two n-tiles of 8 (NT 2)."""
    plan = dec_ops.launch_plan(8, kq, t, 8, 4, 128, torch.bfloat16)
    assert plan.route == "mma" and plan.tile == 64 and plan.chunk == chunk
    assert plan.grid == (64, 2, 1) and plan.splits == 2
    assert plan.kq_panel == kq and -(-plan.kq_panel * 4 // 8) == nt
    assert plan.smem_bytes == 71_184 and plan.smem_bytes <= build.SMEM_PER_BLOCK
    assert dec_ops.launch_plan(8, kq, t, 8, 4, 128, torch.float32).route == "panel"


@pytest.mark.parametrize("b,h,hk,t,dh", [(3, 8, 2, 45, 64), (2, 32, 8, 206, 128)])
def test_single_token_decode_is_the_block_at_cache_len_minus_one(b, h, hk, t, dh):
    """What the single-token route relies on: decode over ``t < len`` is the
    verify block of one query over ``t < (len - 1) + 0 + 1``, for len >= 1,
    in the JAX references and in the port's plain versions."""
    rng = np.random.default_rng(t)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = 1, t
    one = np.asarray(jax_decode_ref(*map(jnp.asarray, (q, k, v, lens))))
    blk = np.asarray(jax_block_ref(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(lens - 1)))[:, 0]
    np.testing.assert_allclose(one, blk, rtol=TOL, atol=TOL)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    port_one = decode_attention_ref(tq, tk, tv, tl)
    port_blk = decode_attention_block_ref(tq[:, None], tk, tv, tl - 1)[:, 0]
    np.testing.assert_allclose(port_one.numpy(), one, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port_blk.numpy(), blk, rtol=TOL, atol=TOL)


def test_paged_wrappers_use_the_plain_version_on_cpu():
    """On CPU tensors both wrappers return the plain versions and count no
    launch."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 3, 8, 64), dtype=np.float32))
    kp = torch.from_numpy(rng.standard_normal((5, 16, 2, 64), dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((5, 16, 2, 64), dtype=np.float32))
    tbl = torch.tensor([[0, 1], [2, 4]], dtype=torch.int32)
    sp = torch.where(torch.arange(20)[None] < torch.tensor([[18], [0]]),
                     torch.arange(20)[None], -1).to(torch.int32)
    qpos = torch.tensor([15, 0], dtype=torch.int32)
    before = (paged_ops.launches, paged_ops.block_launches)
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    assert (paged_ops.launches, paged_ops.block_launches) == before
    ref = paged_ops.paged_decode_attention_block_ref(q, kp, vp, tbl, sp, qpos)
    assert torch.equal(out, ref)
    assert torch.equal(one, paged_ops.paged_decode_attention_ref(q[:, 0], kp, vp, tbl, sp))


def test_c_entry_points_match_their_ctypes_signatures():
    """Each extern "C" entry point of csrc has as many parameters as its
    ctypes signature in build.SIGNATURES (nothing compiles the sources on a
    CPU box, so this is what catches a wrapper and a kernel drifting)."""
    import re
    text = "\n".join(f.read_text() for f in build.CSRC.glob("*.cu"))
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


@pytest.mark.parametrize("b,n,d,block_n", [(8, 262_144, 384, 1024), (8, 1 << 20, 384, 1024),
                                           (3, 5000, 64, 512), (20, 4096, 128, 1024),
                                           (1, 100, 32, 64)])
def test_cosine_scan_plan_covers_the_bank_once(b, n, d, block_n):
    """The chunks tile the bank rows [0, N) once in ascending order (the last
    one ragged), one block per (chunk, group of 8 queries), and the shared
    memory of a scan block fits; at D 384 two blocks share an SM."""
    plan = cos_ops.scan_plan(b, n, d, block_n)
    rows = [r for lo, hi in plan.chunks for r in range(lo, hi)]
    assert rows == list(range(n))
    assert all(hi - lo == block_n for lo, hi in plan.chunks[:-1])
    assert plan.grid == (len(plan.chunks), -(-b // cos_ops.QUERIES_PER_BLOCK))
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK
    if d == 384:
        assert plan.smem_bytes == 86_016 and 2 * plan.smem_bytes <= 228 * 1024 - 2 * 1024


def test_kernel_resources_parse_the_ptxas_log():
    """Registers, static shared memory, stack and spill bytes per kernel from
    nvcc's ``-Xptxas -v`` output (what chip_smoke.py reports beside the
    build); names are demangled where c++filt exists."""
    log = """== flash_attention.cu (rc 0)
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN11repro_torch12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S4_S4_PKiS6_PS2_iiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN11repro_torch12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S4_S4_PKiS6_PS2_iiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 233 registers, used 1 barriers, 128 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6spillyPf' for 'sm_90a'
ptxas info    : Function properties for _Z6spillyPf
    48 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, 400 bytes cmem[0]
"""
    res = build.kernel_resources(log)
    assert len(res) == 2
    flash, spilly = res.values()
    assert flash == {"registers": 233, "smem_bytes": 128, "stack_bytes": 0, "spill_bytes": 0}
    assert spilly == {"registers": 128, "smem_bytes": 0, "stack_bytes": 48, "spill_bytes": 44}
    assert build._short("void repro_torch::(anonymous namespace)::flash_fwd_simt_kernel"
                        "<float, 64>(float const*, int)") == "flash_fwd_simt_kernel<float, 64>"


def test_sass_opcodes_are_counted_per_kernel():
    """The SASS listing's instructions are counted per kernel, predicated
    ones too, and the encoding lines are not."""
    sass = """\tcode for sm_90a
\t\tFunction : _Z1kPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000800 */
        /*0150*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;   /* 0x0418723c */
        /*0290*/               @P0 LDGSTS.E.BYPASS.LTC128B.128 [R7], desc[UR6][R2.64] ;
        /*0300*/              @!P1 LDSM.16.M88.4 R8, [R9] ;
        /*0310*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
\t\tFunction : _Z1gPf
        /*0000*/                   SHFL.BFLY PT, R3, R2, 0x1, 0x1f ;
"""
    res = build.count_opcodes(sass, ("HMMA", "LDSM", "LDGSTS", "SHFL"))
    assert list(res.values()) == [{"HMMA": 2, "LDSM": 1, "LDGSTS": 1, "SHFL": 0},
                                  {"HMMA": 0, "LDSM": 0, "LDGSTS": 0, "SHFL": 1}]
