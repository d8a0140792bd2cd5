"""Port paged KV: the plain paged attention versions against the JAX ``ref.py``
and the Pallas kernels (interpret mode), the page pool's state against the
JAX ``PagePool`` under the same op sequences, ``pack_caches`` /
``rewind_kv`` / ``row_pos_caches`` against JAX, paged greedy generation
against JAX and against the port's dense decode, and the proof that the
single-token paged kernel's narrower mask (``slot_pos >= 0``) equals the
model's (``slot_pos >= 0 & slot_pos <= pos``) on the caches the paged
paths build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ops import (
    paged_decode_attention_block as jax_paged_block)
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro.serving import paged_kv as jax_paged_kv
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import ModelConfig, build_model
from repro_torch.serving import paged_kv
from repro_torch.serving.continuous import leaked_pages
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig

TOL = 2e-5
VOCAB, EOS, MNT = 128, 2, 6
CFG = ModelConfig(name="tiny", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  d_ff=64, vocab_size=VOCAB, max_seq_len=256, dtype="float32",
                  attention_impl="xla_flash", flash_block_q=16, flash_block_k=16)


# ------------------------------------------------------------- kernels

def _paged_case(rng, b, h, hk, dh, page, npg, cap, kq):
    """Pool pages, shuffled block tables with a TRASH row, slot_pos with
    rewound holes; the last row is parked on TRASH with no valid slot."""
    num_pages = b * npg + 2
    q = rng.standard_normal((b, kq, h, dh)).astype(np.float32)
    kp = rng.standard_normal((num_pages + 1, page, hk, dh)).astype(np.float32)
    vp = rng.standard_normal((num_pages + 1, page, hk, dh)).astype(np.float32)
    tbl = rng.permutation(num_pages)[:b * npg].reshape(b, npg).astype(np.int32)
    tbl[-1] = num_pages                                     # TRASH
    sp = np.full((b, cap), -1, np.int32)
    qpos = np.zeros(b, np.int32)
    for r in range(b - 1):
        n = int(rng.integers(1, cap - kq + 1))
        sp[r, :n + kq] = np.arange(n + kq)
        qpos[r] = n
    return q, kp, vp, tbl, sp, qpos


@pytest.mark.parametrize("b,h,hk,dh,page,cap", [(3, 4, 2, 16, 4, 19), (2, 8, 2, 32, 16, 40)])
def test_paged_decode_plain_matches_jax(b, h, hk, dh, page, cap):
    npg = -(-cap // page)
    q, kp, vp, tbl, sp, _ = _paged_case(np.random.default_rng(cap), b, h, hk, dh, page,
                                        npg, cap, 1)
    q = q[:, 0]
    out = paged_ops.paged_decode_attention(*(torch.from_numpy(x) for x in (q, kp, vp, tbl, sp)))
    args = [jnp.asarray(x) for x in (q, kp, vp, tbl, sp)]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_paged(*args, impl="ref")),
                               rtol=TOL, atol=TOL)
    # the Pallas kernel averages a row with no valid slot over whole pages,
    # the reference over cap slots: rows with a valid slot are compared
    seen = (sp >= 0).any(1)
    np.testing.assert_allclose(out.numpy()[seen],
                               np.asarray(jax_paged(*args, impl="pallas"))[seen],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kq,page", [(1, 4), (3, 8), (4, 16)])
def test_paged_block_plain_matches_jax(kq, page):
    b, h, hk, dh, cap = 3, 4, 2, 16, 21
    npg = -(-cap // page)
    arrs = _paged_case(np.random.default_rng(kq + page), b, h, hk, dh, page, npg, cap, kq)
    out = paged_ops.paged_decode_attention_block(*(torch.from_numpy(x) for x in arrs))
    args = [jnp.asarray(x) for x in arrs]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_paged_block(*args, impl="ref")),
                               rtol=TOL, atol=TOL)
    seen = (arrs[4] >= 0).any(1)                          # see the single-token case
    np.testing.assert_allclose(out.numpy()[seen],
                               np.asarray(jax_paged_block(*args, impl="pallas"))[seen],
                               rtol=TOL, atol=TOL)
    # K = 1 with q_pos at the last written slot is the single-token kernel
    if kq == 1:
        single = paged_ops.paged_decode_attention(
            *(torch.from_numpy(x) for x in (arrs[0][:, 0],) + arrs[1:5]))
        np.testing.assert_allclose(out[:, 0].numpy(), single.numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------------------- models

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(JaxModelConfig(**CFG.__dict__))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(CFG)
    return jm, jp, pm, jax_params_to_torch(_flatten(jp), CFG, device="cpu")


def _gens(models, **kw):
    jm, jp, pm, pp = models
    common = dict(max_new_tokens=MNT, eos_id=EOS)
    jg = JaxGenerator(jm, jp, JaxGenerateConfig(
        sampler=JaxSamplerConfig(vocab_size=VOCAB), **common, **kw))
    pg = Generator(pm, pp, GenerateConfig(sampler=SamplerConfig(vocab_size=VOCAB),
                                          **common, **kw))
    return jg, pg


def _prompts(b, s, seed):
    return np.random.default_rng(seed).integers(3, VOCAB, (b, s)).astype(np.int32)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------- pool

def _pool_state(pool):
    return (pool.refcounts().tolist(), list(pool._free), pool.live_pages,
            pool.pinned_pages, pool.free_pages)


def test_pool_bookkeeping_matches_jax(models):
    jm, _, pm, _ = models
    cfg = dict(page_size=4, num_pages=12)
    jpool = jax_paged_kv.PagePool(jm, jax_paged_kv.PagePoolConfig(**cfg))
    ppool = paged_kv.PagePool(pm, paged_kv.PagePoolConfig(**cfg), device="cpu")
    assert ppool.storage["scan"][0]["kp"].shape == (2, 13, 4, 2, 8)
    assert ppool.trash_page == 12
    log = []
    for pool in (jpool, ppool):
        steps = []
        a = pool.alloc(3)
        steps.append((a.tolist(), _pool_state(pool)))
        pool.incref(a[:1], count=2)
        pool.decref(a)
        steps.append(_pool_state(pool))
        tbl, wr = pool.alloc_block_table(2, 13)          # 4 pages per row
        steps.append((tbl.tolist(), wr.tolist(), _pool_state(pool)))
        with pytest.raises(jax_paged_kv.PagePoolExhausted if pool is jpool
                           else paged_kv.PagePoolExhausted):
            pool.alloc_block_table(2, 13)                  # needs 8, 3 free
        steps.append(_pool_state(pool))                    # unchanged
        with pytest.raises(RuntimeError):
            pool.alloc(99)
        pool.free_block_table(tbl, wr)
        pool.decref(np.concatenate([a[:1], a[:1]]))       # refcount 2 -> 0
        steps.append(_pool_state(pool))
        with pytest.raises(RuntimeError, match="over-freed"):
            pool.decref(a[:1])
        log.append(steps)
    assert log[0] == log[1]


def test_pinned_prefix_sharing_matches_jax(models):
    jg, pg = _gens(models, paged=True, page_size=4, pool_pages=64)
    prefix = _prompts(1, 10, 3)[0].tolist()                # 2 full pages + 2 tokens
    suf = _prompts(3, 5, 4)
    out = []
    for g, put in ((jg, jnp.asarray), (pg, np.asarray)):
        pc = g.build_prefix_cache(prefix, 3)
        res = g.generate_with_lengths({"tokens": put(suf)}, seed=0, prefix_cache=pc)
        pool = g.pool
        pin = pool.ensure_pinned(pc)
        assert len(pin.ids) == 2 and pool.pinned_pages == 2
        assert pool.refcounts()[pin.ids].tolist() == [1, 1]   # rows released, pin held
        assert pool.live_pages == 2 and leaked_pages(g) == 0
        tbl, wr = pool.alloc_block_table(3, pc.length + 5 + MNT + 1, pin)
        assert (tbl[:, :2] == pin.ids).all() and not wr[:, :2].any()
        assert pool.refcounts()[pin.ids].tolist() == [4, 4]
        pool.free_block_table(tbl, wr)
        pool.unpin(pin.key)
        assert pool.live_pages == 0
        out.append((res, pin.ids.tolist()))
    _assert_same(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


# ---------------------------------------------------- pack / rewind / row_pos

def test_pack_rewind_row_pos_match_jax(models):
    jm, jp, pm, pp = models
    toks = _prompts(3, 9, 5)
    cap, page = 9 + MNT + 1, 4
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap)
    _, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    jpool = jax_paged_kv.PagePool(jm, jax_paged_kv.PagePoolConfig(page, 20))
    ppool = paged_kv.PagePool(pm, paged_kv.PagePoolConfig(page, 20), device="cpu")
    tbl, wr = jpool.alloc_block_table(3, cap)
    assert ppool.alloc_block_table(3, cap)[0].tolist() == tbl.tolist()
    wr[1, 0] = False                                      # a read-only entry -> TRASH
    jpaged = jax_paged_kv.pack_caches(jpool.storage, jc, jnp.asarray(tbl), jnp.asarray(wr))
    ppaged = paged_kv.pack_caches(ppool.storage, pc, torch.from_numpy(tbl),
                                  torch.from_numpy(wr))
    ppool.adopt(ppaged)
    jleaf, pleaf = jpaged["scan"][0], ppaged["scan"][0]
    live = tbl[wr]                                         # written pages (not TRASH)
    for key, dkey in (("kp", "k"), ("vp", "v")):
        # the pages hold the port's own dense KV exactly, and JAX's within
        # the prefill's float tolerance
        dense = pc["scan"][0][dkey].numpy()
        dense = np.pad(dense, ((0, 0), (0, 0), (0, 4 * tbl.shape[1] - cap), (0, 0), (0, 0)))
        dense = dense.reshape(2, 3, tbl.shape[1], page, *dense.shape[3:])
        np.testing.assert_array_equal(pleaf[key][:, live].numpy(), dense[:, wr])
        np.testing.assert_allclose(pleaf[key][:, live].numpy(),
                                   np.asarray(jleaf[key])[:, live], rtol=1e-5, atol=1e-5)
        assert ppool.storage["scan"][0][key] is pleaf[key]     # written in place
    np.testing.assert_array_equal(pleaf["block_tbl"].numpy(), np.asarray(jleaf["block_tbl"][0]))
    np.testing.assert_array_equal(pleaf["slot_pos"].numpy(), np.asarray(jleaf["slot_pos"]))
    np.testing.assert_array_equal(ppaged["pos"].numpy(), np.asarray(jleaf["pos"][0]))
    # per-row positions, then a rewind by different amounts per row
    jrow = jax_paged_kv.row_pos_caches(jc, 3)
    prow = paged_kv.row_pos_caches(pc, 3)
    np.testing.assert_array_equal(prow["pos"].numpy(), np.asarray(jrow["pos"]))
    back = np.array([0, 2, 5], np.int32)
    jrew = jax_paged_kv.rewind_kv(jrow, jnp.asarray(back))
    prew = paged_kv.rewind_kv(prow, torch.from_numpy(back))
    np.testing.assert_array_equal(prew["pos"].numpy(), np.asarray(jrew["pos"]))
    np.testing.assert_array_equal(prew["scan"][0]["slot_pos"].numpy(),
                                  np.asarray(jrew["scan"][0]["slot_pos"]))
    jprew = jax_paged_kv.rewind_kv(jpaged, jnp.asarray(back))
    pprew = paged_kv.rewind_kv(ppaged, torch.from_numpy(back))
    np.testing.assert_array_equal(pprew["scan"][0]["slot_pos"].numpy(),
                                  np.asarray(jprew["scan"][0]["slot_pos"]))
    np.testing.assert_array_equal(pprew["pos"].numpy(), np.asarray(jprew["scan"][0]["pos"][0]))


# ---------------------------------------------------- paged generation

@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_paged_generation_matches_jax_and_dense(models, page_size):
    jg, pg = _gens(models, paged=True, page_size=page_size)
    _, dense = _gens(models)
    toks = _prompts(3, 7, page_size)
    j = jg.generate_with_lengths({"tokens": jnp.asarray(toks)}, seed=0)
    p = pg.generate_with_lengths({"tokens": toks}, seed=0)
    _assert_same(p, j)
    _assert_same(p, dense.generate_with_lengths({"tokens": toks}, seed=0))
    _assert_same(p, pg.generate_with_lengths({"tokens": toks}, seed=0, fused=False))
    assert pg.pool.live_pages == 0 and leaked_pages(pg, dense) == 0


def test_paged_temperature_equals_dense_in_port(models):
    """Sampling draws the same noise through paged and dense decode."""
    hot = SamplerConfig(temperature=0.9, vocab_size=VOCAB)
    _, pm, pp = models[0], models[2], models[3]
    paged = Generator(pm, pp, GenerateConfig(max_new_tokens=MNT, eos_id=EOS, sampler=hot,
                                             paged=True, page_size=4))
    dense = Generator(pm, pp, GenerateConfig(max_new_tokens=MNT, eos_id=EOS, sampler=hot))
    toks = _prompts(2, 6, 9)
    _assert_same(paged.generate_with_lengths({"tokens": toks}, seed=4),
                 dense.generate_with_lengths({"tokens": toks}, seed=4))


def test_pool_exhaustion_in_generate_leaves_pool_clean(models):
    _, pg = _gens(models, paged=True, page_size=4, pool_pages=4)
    small = _prompts(1, 3, 5)
    first = pg.generate_with_lengths({"tokens": small}, seed=0)   # builds the 4-page pool
    with pytest.raises(paged_kv.PagePoolExhausted):
        pg.generate_with_lengths({"tokens": _prompts(4, 7, 6)})  # needs 16 pages
    assert pg.pool.live_pages == 0 and pg.pool.free_pages == 4
    _assert_same(pg.generate_with_lengths({"tokens": small}, seed=0), first)


def test_paged_decode_mask_equals_model_mask(models):
    """On the caches paged decode builds (prefill, then steps through the
    block table, at and past the capacity), every written slot holds a
    position <= the row's current one: the kernel's ``slot_pos >= 0``
    keeps exactly the model's ``slot_pos >= 0 & slot_pos <= pos``."""
    _, _, pm, pp = models
    toks = _prompts(2, 5, 2)
    cap = 5 + 3
    _, dense = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    pool = paged_kv.PagePool(pm, paged_kv.PagePoolConfig(4, 8), device="cpu")
    tbl, wr = pool.alloc_block_table(2, cap)
    caches = paged_kv.pack_caches(pool.storage, dense, torch.from_numpy(tbl),
                                  torch.from_numpy(wr))
    tok = torch.from_numpy(toks[:, -1]).int()
    for _ in range(6):                                    # runs past cap
        _, caches = pm.decode_step(pp, tok, caches)
        sp = caches["scan"][0]["slot_pos"]
        cur = caches["pos"][None, :, None] - 1            # the step's query position
        assert torch.equal(sp >= 0, (sp >= 0) & (sp <= cur))
        assert bool((sp >= 0).any(-1).all())
