"""Port ``DecodeSession``: continuous batching over the page pool against the
JAX package's session on the same join/leave trace, the inaugural cohort
against dense ``generate_with_lengths``, fused chunks against the
host-stepped oracle, chunk-size and co-resident invariance, admission
guards, zero leaked pages, and the single-token paged kernel's mask
(``slot_pos >= 0``) against the model's through eviction and re-admission."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro.serving.continuous import DecodeSession as JaxSession
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.models import ModelConfig, build_model
from repro_torch.serving.continuous import (DecodeSession, FinishedRow, NoFreeSlots,
                                            leaked_pages)
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.paged_kv import PagePoolExhausted
from repro_torch.serving.sampler import SamplerConfig
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

VOCAB, EOS, MNT, S = 128, 2, 6, 7
CAP = S + MNT + 1
CFG = ModelConfig(name="tiny", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  d_ff=64, vocab_size=VOCAB, max_seq_len=256, dtype="float32",
                  attention_impl="xla_flash", flash_block_q=16, flash_block_k=16)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(JaxModelConfig(**CFG.__dict__))
    jp = jm.init(jax.random.PRNGKey(1))
    pm = build_model(CFG)
    return jm, jp, pm, jax_params_to_torch(_flatten(jp), CFG, device="cpu")


def _gen(models, jax_side=False, **kw):
    jm, jp, pm, pp = models
    common = dict(max_new_tokens=MNT, eos_id=EOS, page_size=4, **kw)
    if jax_side:
        return JaxGenerator(jm, jp, JaxGenerateConfig(
            sampler=JaxSamplerConfig(vocab_size=VOCAB), **common))
    return Generator(pm, pp, GenerateConfig(sampler=SamplerConfig(vocab_size=VOCAB), **common))


def _prompts(b, s, seed):
    return np.random.default_rng(seed).integers(3, VOCAB, (b, s)).astype(np.int32)


def _churn(sess, *, fused=True, chunk=2, check=None):
    """A join/leave trace: cohorts of 2, 1, 2, 1, 3 rows admitted as slots
    free; returns {tag: (tokens, length, ended)}."""
    pending = [_prompts(k, S, 100 + i) for i, k in enumerate((2, 1, 2, 1, 3))]
    results, tag = {}, 0
    for _ in range(60):
        while pending and pending[0].shape[0] <= sess.free_slots:
            cohort = pending.pop(0)
            k = cohort.shape[0]
            sess.admit(cohort, tags=list(range(tag, tag + k)))
            tag += k
        sess.run_chunk(chunk, fused=fused)
        if check is not None:
            check(sess)
        for f in sess.harvest():
            results[f["tag"]] = (f["tokens"].tolist(), f["length"], f["ended"])
        if not pending and sess.free_slots == sess.slots:
            break
    assert not pending and sess.free_slots == sess.slots
    assert sess.pool.live_pages == 0 and leaked_pages(sess) == 0
    return results


def test_session_churn_matches_jax(models):
    jsess = JaxSession(_gen(models, jax_side=True), slots=4, capacity=CAP, seed=11)
    pending = [_prompts(k, S, 100 + i) for i, k in enumerate((2, 1, 2, 1, 3))]
    jres, tag = {}, 0
    for _ in range(60):
        while pending and pending[0].shape[0] <= jsess.free_slots:
            cohort = pending.pop(0)
            jsess.admit(jnp.asarray(cohort), tags=list(range(tag, tag + cohort.shape[0])))
            tag += cohort.shape[0]
        jsess.run_chunk(2)
        for f in jsess.harvest():
            jres[f["tag"]] = (np.asarray(f["tokens"]).tolist(), f["length"], f["ended"])
        if not pending and jsess.free_slots == jsess.slots:
            break
    pres = _churn(DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11))
    assert len(pres) == 9 and pres == jres


def test_inaugural_cohort_equals_dense(models):
    toks = _prompts(3, S, 7)
    dense = _gen(models).generate_with_lengths({"tokens": toks}, seed=5)
    sess = DecodeSession(_gen(models), slots=3, capacity=CAP, seed=5)
    sess.admit(toks, tags=["a", "b", "c"])
    fins = sorted(sess.drain(), key=lambda f: f["slot"])
    assert all(isinstance(f, FinishedRow) for f in fins)
    np.testing.assert_array_equal(np.stack([f["tokens"] for f in fins]), dense[0])
    assert [f["length"] for f in fins] == dense[1].tolist()
    assert [f["ended"] for f in fins] == dense[2].tolist()
    assert [f["tag"] for f in fins] == ["a", "b", "c"]
    assert sess.pool.live_pages == 0 and sess.free_slots == 3


def test_inaugural_cohort_equals_dense_under_sampling(models):
    """The session draws its noise as the dense fused loop does: a full
    inaugural cohort under temperature replays it (same seed)."""
    _, _, pm, pp = models
    cfg = GenerateConfig(max_new_tokens=MNT, eos_id=EOS, page_size=4,
                         sampler=SamplerConfig(temperature=0.9, vocab_size=VOCAB))
    toks = _prompts(2, S, 8)
    dense = Generator(pm, pp, cfg).generate_with_lengths({"tokens": toks}, seed=3)
    sess = DecodeSession(Generator(pm, pp, cfg), slots=2, capacity=CAP, seed=3)
    sess.admit(toks)
    fins = sorted(sess.drain(), key=lambda f: f["slot"])
    np.testing.assert_array_equal(np.stack([f["tokens"] for f in fins]), dense[0])


def test_fused_equals_host_oracle_and_chunk_invariance(models):
    runs = {}
    for fused, chunk in ((True, 2), (False, 2), (True, 3), (True, MNT)):
        sess = DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11)
        runs[(fused, chunk)] = _churn(sess, fused=fused, chunk=chunk)
    base = runs[(True, 2)]
    assert len(base) == 9
    for r in runs.values():
        assert r == base


def test_row_invariant_to_co_residents(models):
    p0, other = _prompts(1, S, 8), _prompts(2, S, 9)
    solo = DecodeSession(_gen(models), slots=3, capacity=CAP, seed=3)
    solo.admit(p0, slots=[1])
    t_solo = solo.drain()[0]["tokens"]
    busy = DecodeSession(_gen(models), slots=3, capacity=CAP, seed=3)
    busy.admit(other, slots=[0, 2])
    busy.run_chunk(2)                                     # co-residents mid-flight
    busy.admit(p0, slots=[1], tags=["pin"])
    t_co = next(f["tokens"] for f in busy.drain() if f["tag"] == "pin")
    np.testing.assert_array_equal(t_solo, t_co)
    assert busy.pool.live_pages == 0


def test_admission_guards(models):
    sess = DecodeSession(_gen(models), slots=2, capacity=14)
    with pytest.raises(ValueError, match="exceeds session capacity"):
        sess.admit(_prompts(1, 14, 0))
    sess.admit(_prompts(2, S, 1))
    with pytest.raises(NoFreeSlots):
        sess.admit(_prompts(1, S, 2))
    with pytest.raises(NoFreeSlots):
        sess.admit(_prompts(1, S, 2), slots=[0])          # occupied slot
    sess.drain()
    assert sess.free_slots == 2 and sess.pool.live_pages == 0
    tight = DecodeSession(_gen(models), slots=2, capacity=14)
    tight.pool._free = tight.pool._free[:1]                # all but one page in use
    with pytest.raises(PagePoolExhausted):
        tight.admit(_prompts(1, S, 3))
    assert tight.free_slots == 2 and tight.pool.refcounts().sum() == 0   # nothing spliced


def test_off_slice_session_options(models):
    """The reference's session guards: spec_k >= 1, speculation greedy-only
    and within the token budget, drafts only on a spec session."""
    with pytest.raises(ValueError, match="spec_k"):
        DecodeSession(_gen(models), slots=2, capacity=CAP, spec_k=0)
    _, _, pm, pp = models
    hot = Generator(pm, pp, GenerateConfig(
        max_new_tokens=MNT, eos_id=EOS, page_size=4,
        sampler=SamplerConfig(temperature=0.5, vocab_size=VOCAB)))
    with pytest.raises(ValueError, match="greedy"):
        DecodeSession(hot, slots=2, capacity=CAP, spec_k=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        DecodeSession(_gen(models), slots=2, capacity=CAP, spec_k=MNT + 1)
    plain = DecodeSession(_gen(models), slots=2, capacity=CAP)
    with pytest.raises(ValueError, match="drafts"):
        plain.admit(_prompts(1, S, 0), drafts=(np.zeros((1, 2), np.int32),
                                                np.ones((1,), np.int32)))
    assert plain.spec_stats == {"proposed": 0, "accepted": 0, "spec_steps": 0}


def test_session_mask_equals_model_mask(models):
    """Through admission, eviction to TRASH and re-admission, every written
    slot of every row holds a position <= the row's last query position, so
    the paged kernel's ``slot_pos >= 0`` is the model's mask."""
    def check(sess):
        leaf = sess.state["caches"]["scan"][0]
        sp = leaf["slot_pos"]
        cur = sess.state["caches"]["pos"][None, :, None] - 1
        assert torch.equal(sp >= 0, (sp >= 0) & (sp <= cur))
        occupied = sess.state["occupied"]
        assert bool((sp >= 0).any(-1)[:, occupied].all())

    _churn(DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11), check=check)


# ------------------------------------------------ spec_k > 1 sessions
SPEC_COHORTS = (2, 1, 2, 1, 3)


def _spec_drafts(plain_res, seed):
    """Per cohort, drafts cut from the plain session's tokens: a true
    continuation, garbage, a short true prefix, a one-token edit, none."""
    rng = np.random.default_rng(seed)
    out, tag = [], 0
    for k in SPEC_COHORTS:
        ids = np.zeros((k, MNT), np.int32)
        lens = np.zeros((k,), np.int32)
        for r in range(k):
            true = np.asarray(plain_res[tag + r][0], np.int32)
            kind = (tag + r) % 5
            ids[r] = true if kind != 1 else rng.integers(3, VOCAB, MNT)
            if kind == 3:
                ids[r, 2] = (ids[r, 2] + 1) % VOCAB
            lens[r] = (MNT, MNT, 2, MNT, 0)[kind]
        out.append((ids, lens))
        tag += k
    return out


def _spec_churn(sess, drafts, admit=None, chunk=2):
    """The churn of ``_churn`` with per-cohort drafts; ``admit`` converts a
    cohort for the session's framework."""
    admit = admit or (lambda x: x)
    pending = [(_prompts(k, S, 100 + i), drafts[i]) for i, k in enumerate(SPEC_COHORTS)]
    results, tag = {}, 0
    for _ in range(60):
        while pending and pending[0][0].shape[0] <= sess.free_slots:
            cohort, d = pending.pop(0)
            k = cohort.shape[0]
            sess.admit(admit(cohort), tags=list(range(tag, tag + k)), drafts=d)
            tag += k
        sess.run_chunk(chunk)
        for f in sess.harvest():
            results[f["tag"]] = (np.asarray(f["tokens"]).tolist(), f["length"], f["ended"])
        if not pending and sess.free_slots == sess.slots:
            break
    assert not pending and sess.free_slots == sess.slots
    return results


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_session_churn_matches_jax_and_plain(models, spec_k):
    """Through a join/leave churn with drafts that track, diverge, run out
    or are absent, the spec session equals JAX's spec session (tokens,
    lengths, flags and ``spec_stats``) and the plain session's tokens."""
    plain = _churn(DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11))
    drafts = _spec_drafts(plain, 5)
    jsess = JaxSession(_gen(models, jax_side=True), slots=4, capacity=CAP, seed=11,
                       spec_k=spec_k)
    jres = _spec_churn(jsess, drafts, admit=jnp.asarray)
    sess = DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11, spec_k=spec_k)
    pres = _spec_churn(sess, drafts)
    assert len(pres) == 9 and pres == jres == plain
    stats = sess.spec_stats
    assert stats == jsess.spec_stats
    assert stats["proposed"] >= stats["accepted"] > 0 and stats["spec_steps"] > 0
    assert sess.pool.live_pages == 0 and leaked_pages(sess) == 0


def test_spec_session_masked_blocks_change_nothing(models):
    """Blocks run after every row is done (the eager chunk's done-masking)
    leave tokens, state and counters as they were."""
    toks = _prompts(2, S, 7)
    ref = DecodeSession(_gen(models), slots=2, capacity=CAP)
    ref.admit(toks)
    plain = sorted(ref.drain(), key=lambda f: f["slot"])
    drafts = (np.stack([f["tokens"] for f in plain]), np.full((2,), MNT, np.int32))
    sess = DecodeSession(_gen(models), slots=3, capacity=CAP, spec_k=3)
    sess.admit(toks, drafts=drafts)
    sess.run_chunk(MNT)
    stats = sess.spec_stats
    keep = {k: v.clone() for k, v in sess.state.items() if torch.is_tensor(v)}
    sp = sess.state["caches"]["scan"][0]["slot_pos"].clone()
    sess.run_chunk(3)
    assert sess.spec_stats == stats and stats["spec_steps"] < MNT - 1
    for k, v in keep.items():
        assert torch.equal(sess.state[k], v), k
    assert torch.equal(sess.state["caches"]["scan"][0]["slot_pos"], sp)
    fins = sorted(sess.harvest(), key=lambda f: f["slot"])
    for f, p in zip(fins, plain):
        np.testing.assert_array_equal(f["tokens"], p["tokens"])
        assert (f["length"], f["ended"]) == (p["length"], p["ended"])


def test_spec_session_fused_equals_host_oracle(models):
    """Fused chunks equal the host-stepped oracle (counters included), and
    a row's tokens and its proposed/accepted counts do not depend on chunk
    size (``spec_steps`` counts shared blocks, so it does)."""
    plain = _churn(DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11))
    drafts = _spec_drafts(plain, 6)
    runs = {}
    for fused, chunk in ((True, 2), (False, 2), (True, 1), (True, 3)):
        sess = DecodeSession(_gen(models), slots=4, capacity=CAP, seed=11, spec_k=3)
        run = sess.run_chunk
        sess.run_chunk = lambda steps, run=run, fused=fused: run(steps, fused=fused)
        runs[(fused, chunk)] = (_spec_churn(sess, drafts, chunk=chunk), sess.spec_stats)
    assert runs[(True, 2)] == runs[(False, 2)]
    for res, stats in runs.values():
        assert res == plain
        assert ({k: stats[k] for k in ("proposed", "accepted")}
                == {k: runs[(True, 2)][1][k] for k in ("proposed", "accepted")})
