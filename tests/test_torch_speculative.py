"""Port speculative decode: the plain dense q-block attention against the JAX
``ref.py`` and the Pallas kernel (interpret mode); greedy speculative
generation, dense and paged, against the JAX package's tokens, lengths and
``spec_stats`` (``spec_steps`` equal) and against the port's plain decode;
the host-sync count of the verify loop; the proof that the dense q-block
kernel's mask (``t < cache_len + i + 1``) equals the model's on the caches
the verify loop builds; the configuration checks; and a paged, speculating
engine trace against the JAX engine."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.core import TweakLLMEngine as JaxEngine
from repro.kernels.decode_attention.ops import decode_attention_block as jax_block
from repro.launch.serve import build_stack as jax_build_stack
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.core.tweak import preprocess_query
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.launch.serve import model_configs
from repro_torch.models import ModelConfig, build_model
from repro_torch.serving import paged_kv
from repro_torch.serving.continuous import leaked_pages
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.tokenizer.tokenizer import SPECIAL_TOKENS
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = 2e-5
VOCAB, EOS, MNT = 128, 2, 8
CFG = ModelConfig(name="tiny", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  d_ff=64, vocab_size=VOCAB, max_seq_len=256, dtype="float32",
                  attention_impl="xla_flash", flash_block_q=16, flash_block_k=16)


# ------------------------------------------------------------- kernel

@pytest.mark.parametrize("b,kq,t,h,hk,dh", [(3, 4, 23, 4, 2, 16), (2, 1, 40, 8, 8, 32),
                                            (2, 3, 17, 8, 1, 16)])
def test_block_plain_matches_jax(b, kq, t, h, hk, dh):
    rng = np.random.default_rng(t + kq)
    q = rng.standard_normal((b, kq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    lens = rng.integers(0, t - kq + 1, b).astype(np.int32)
    out = dec_ops.decode_attention_block(*(torch.from_numpy(x) for x in (q, k, v, lens)))
    args = [jnp.asarray(x) for x in (q, k, v, lens)]
    for impl in ("ref", "pallas"):
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_block(*args, impl=impl)),
                                   rtol=TOL, atol=TOL)
    if kq == 1:     # K = 1 is the single-token kernel at cache_len + 1
        single = dec_ops.decode_attention(*(torch.from_numpy(x) for x in (q[:, 0], k, v,
                                                                           lens + 1)))
        np.testing.assert_allclose(out[:, 0].numpy(), single.numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------------------- generation

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


def _drafts(ref, pattern, seed):
    """(ids, lens) agreeing with the plain output ``ref`` in a pattern."""
    b, w = ref.shape
    rng = np.random.default_rng(seed)
    shift = (ref + 1 - 3) % (VOCAB - 3) + 3                 # never equal to ref
    ids, lens = ref.copy(), np.full(b, w, np.int32)
    if pattern == "zero":
        ids = shift
    elif pattern == "diverge":
        ids[:, w // 2:] = shift[:, w // 2:]
    elif pattern == "short":
        lens[:] = 3
    elif pattern == "mixed":
        for r in range(b):
            if r % 4 == 1:
                ids[r] = shift[r]
            elif r % 4 == 2:
                ids[r, int(rng.integers(1, w)):] = shift[r, 0]
            elif r % 4 == 3:
                lens[r] = 0
    return ids, lens


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_spec_matches_jax_and_plain(models, paged, k):
    jplain, plain = _gens(models, paged=paged, page_size=4)
    jspec, spec = _gens(models, paged=paged, page_size=4, spec_k=k)
    toks = _prompts(4, 6, k)
    ref = plain.generate_with_lengths({"tokens": toks}, seed=0)
    _assert_same(ref, jplain.generate_with_lengths({"tokens": jnp.asarray(toks)}, seed=0))
    for i, pattern in enumerate(("perfect", "zero", "diverge", "short", "mixed")):
        d = _drafts(ref[0], pattern, i)
        out = spec.generate_with_lengths({"tokens": toks}, seed=0, drafts=d)
        jout = jspec.generate_with_lengths({"tokens": jnp.asarray(toks)}, seed=0, drafts=d)
        _assert_same(out, ref)
        _assert_same(out, jout)
        assert spec.last_spec_stats == jspec.last_spec_stats, pattern
        assert spec.last_spec_syncs == spec.last_spec_stats["spec_steps"] + 2
    assert spec.spec_stats == jspec.spec_stats
    assert leaked_pages(spec, plain) == 0


def test_spec_counters_on_perfect_and_bad_drafts(models):
    _, plain = _gens(models)
    _, spec = _gens(models, spec_k=4)
    toks = _prompts(2, 5, 9)
    ref = plain.generate_with_lengths({"tokens": toks}, seed=0)
    spec.generate_with_lengths({"tokens": toks}, drafts=(ref[0], np.full(2, MNT, np.int32)))
    st = dict(spec.last_spec_stats)
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"] and st["spec_steps"] > 0
    # a perfect draft of 8 tokens at k = 4, token 0 from the prefill: two
    # blocks emit 4 + 3 tokens and feed 3 + 3 drafted ones per row
    if not ref[2].any():
        assert st == {"proposed": 12, "accepted": 12, "spec_steps": 2}
    bad = (ref[0] + 1 - 3) % (VOCAB - 3) + 3
    out = spec.generate_with_lengths({"tokens": toks}, drafts=(bad, np.full(2, MNT, np.int32)))
    _assert_same(out, ref)
    assert spec.last_spec_stats == {"proposed": 0, "accepted": 0, "spec_steps": 0}
    assert spec.last_spec_syncs == 2


def test_prefix_cache_spec_paged_matches_jax(models):
    """The TWEAK shape: suffix over a pinned shared prefix, paged, with drafts."""
    jg, pg = _gens(models, paged=True, page_size=4, spec_k=4, pool_pages=96)
    _, plain = _gens(models)
    prefix = _prompts(1, 13, 1)[0].tolist()
    suf = _prompts(3, 6, 2)
    full = np.concatenate([np.broadcast_to(np.asarray(prefix, np.int32), (3, 13)), suf], 1)
    ref = plain.generate_with_lengths({"tokens": full}, seed=0)
    d = _drafts(ref[0], "mixed", 3)
    out = pg.generate_with_lengths({"tokens": suf}, drafts=d,
                                   prefix_cache=pg.build_prefix_cache(prefix, 3))
    jout = jg.generate_with_lengths({"tokens": jnp.asarray(suf)}, drafts=d,
                                    prefix_cache=jg.build_prefix_cache(prefix, 3))
    _assert_same(out, ref)
    _assert_same(out, jout)
    assert pg.last_spec_stats == jg.last_spec_stats
    assert pg.pool.pinned_pages == 3 and leaked_pages(pg) == 0


def test_block_mask_equals_model_mask(models):
    """On the caches the verify loop builds (prefill, blocks of k, rewinds of
    different lengths per row, blocks past the capacity), slot t of a dense
    cache satisfies ``slot_pos >= 0 & slot_pos <= pos + i`` exactly when
    ``t < pos + i + 1``: the dense q-block kernel's mask."""
    _, _, pm, pp = models
    toks = _prompts(3, 5, 4)
    cap, k = 5 + 6, 4
    _, dense = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    caches = paged_kv.row_pos_caches(dense, 3)
    rng = np.random.default_rng(0)
    for _ in range(4):
        pos = caches["pos"].clone()
        x = torch.from_numpy(rng.integers(3, VOCAB, (3, k))).int()
        _, caches = pm.decode_block(pp, x, caches)
        sp = caches["scan"][0]["slot_pos"]                       # (L,B,cap)
        t = torch.arange(cap)
        for i in range(k):
            lim = (pos + i)[None, :, None]
            model = (sp >= 0) & (sp <= lim)
            assert torch.equal(model, (t[None, None, :] < lim + 1).expand_as(model))
        back = torch.from_numpy(rng.integers(0, k, 3)).int()
        caches = paged_kv.rewind_kv(caches, back)


def test_generate_config_validation():
    with pytest.raises(ValueError, match="spec_k"):
        GenerateConfig(spec_k=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        GenerateConfig(max_new_tokens=4, spec_k=8)
    with pytest.raises(ValueError, match="greedy|temperature"):
        GenerateConfig(spec_k=2, sampler=SamplerConfig(temperature=0.7))
    # an architecture that cannot rewind (every stack the port builds that
    # is not windowed can, so a stand-in says so)
    no_rewind = type("NoRewind", (), {"supports_spec_decode": False, "cfg": CFG})()
    with pytest.raises(ValueError, match="spec_k"):
        Generator(no_rewind, {"embed": torch.zeros(1)}, GenerateConfig(spec_k=2))


def test_drafts_call_path_validation(models):
    _, gen = _gens(models, spec_k=2)
    toks = _prompts(1, 4, 0)
    d = (np.zeros((1, 2), np.int32), np.zeros((1,), np.int32))
    with pytest.raises(ValueError, match="fused"):
        gen.generate_with_lengths({"tokens": toks}, drafts=d, fused=False)
    with pytest.raises(ValueError, match="spec_k|budget|max_new"):
        gen.generate_with_lengths({"tokens": toks}, drafts=d, max_new_tokens=1)
    _, pm, pp = models[0], models[2], models[3]
    hot = Generator(pm, pp, GenerateConfig(max_new_tokens=MNT, sampler=SamplerConfig(
        temperature=0.8, vocab_size=VOCAB)))
    with pytest.raises(ValueError, match="greedy|temperature"):
        hot.generate_with_lengths({"tokens": toks}, drafts=d)
    assert gen.speculation_ready and not hot.speculation_ready


# ------------------------------------------------------------- engine

ENG_VOCAB, CAPACITY, THRESHOLD, ENG_MNT = 4096, 64, 0.96, 6


def _ids(text):
    """Token ids of a generated response (the tokenizer renders id i as wi)."""
    special = {f"<{k}>": v for k, v in SPECIAL_TOKENS.items()}
    return [special[w] if w in special else int(re.fullmatch(r"w(\d+)", w).group(1))
            for w in text.split()]


def _engines():
    jstack = jax_build_stack(vocab=ENG_VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    paged = dict(paged=True, pool_pages=256)
    jgens = {k: JaxGenerator(jstack[k].model, jstack[k].params,
                             dataclasses.replace(jstack[k].cfg, **paged,
                                                 spec_k=4 if k == "small" else 1))
             for k in ("big", "small")}
    jeng = JaxEngine(**{**jstack, **jgens})
    big_cfg, small_cfg, ecfg, _ = model_configs("serve-tiny", ENG_VOCAB)
    pgens = {}
    for k, c in (("big", big_cfg), ("small", small_cfg)):
        gcfg = GenerateConfig(max_new_tokens=16, sampler=SamplerConfig(vocab_size=ENG_VOCAB),
                              spec_k=4 if k == "small" else 1, **paged)
        pgens[k] = Generator(build_model(c), jax_params_to_torch(
            _flatten(jstack[k].params), c, device="cpu"), gcfg)
    peng = TweakLLMEngine(
        tokenizer=HashWordTokenizer(ENG_VOCAB),
        embedder_params=jax_params_to_torch(_flatten(jstack["embedder_params"]), ecfg,
                                            device="cpu"),
        embedder_cfg=ecfg, cache_cfg=CacheConfig(capacity=CAPACITY, dim=ecfg.d_model),
        router_cfg=RouterConfig(tweak_threshold=THRESHOLD), **pgens)
    return jeng, peng


def test_paged_spec_engine_trace_matches_jax():
    """Paged generators, a speculating small one, and drafts that the bank's
    ``draft_store`` takes from a first pass: the second pass of the same
    TWEAK queries verifies its own earlier output, so speculation arms."""
    jeng, peng = _engines()
    g = QuestionPairGenerator(seed=4)
    cached = [g._random_query() for _ in range(5)]
    fresh = [g._random_query().text for _ in range(3)]
    pairs = ([q.text for q in cached],
             [synthesize_response(q.text, q.topic, q.intent) for q in cached])
    edits = [q.text + " please" for q in cached[:3]]
    batch = [edits[0], fresh[0], cached[3].text, edits[1], edits[2], fresh[1]]
    for eng in (jeng, peng):
        eng.populate(*pairs)
    first = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        first[name] = eng.handle_batch(batch, max_new_tokens=ENG_MNT, collect_meta=True)
    assert first["jax"][0] == first["port"][0]
    assert [m["decision"] for m in first["jax"][1]] == [m["decision"] for m in first["port"][1]]
    tweak_rows = [i for i, m in enumerate(first["port"][1]) if m["decision"] == 1]
    assert len(tweak_rows) >= 2
    for eng in (jeng, peng):
        slot_of = {q: s for s, (q, _) in eng.bank.text_store.items()}
        for i in tweak_rows:        # the hit is the populated query the edit came from
            src = preprocess_query(batch[i][:-len(" please")])
            eng.bank.draft_store[slot_of[src]] = _ids(first["port"][0][i])
    second = {name: eng.handle_batch(batch, max_new_tokens=ENG_MNT, collect_meta=True)
              for name, eng in (("jax", jeng), ("port", peng))}
    assert second["port"][0] == second["jax"][0]
    assert [second["port"][0][i] for i in tweak_rows] == [first["port"][0][i]
                                                          for i in tweak_rows]
    for a, b in zip(second["port"][1], second["jax"][1]):
        assert a["decision"] == b["decision"] and a["gen_tokens"] == b["gen_tokens"]
    js, ps = jeng.stats, peng.stats
    for f in ("total", "miss", "tweak", "exact", "big_tokens", "small_tokens",
              "big_prompt_tokens", "small_prompt_tokens", "baseline_prompt_tokens",
              "proposed", "accepted", "spec_steps"):
        assert getattr(ps, f) == getattr(js, f), f
    assert ps.proposed > 0 and ps.accepted > 0
    assert ps.acceptance_rate == pytest.approx(js.acceptance_rate)
    assert leaked_pages(peng.big, peng.small) == 0
