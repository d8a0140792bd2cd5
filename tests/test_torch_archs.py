"""The dense attention variants of the port against the JAX package on the
CPU, fp32: qwen2.5-3b (QKV bias), deepseek-coder-33b (a llama-arch stack at
G 4 in its smoke config), h2o-danube-1.8b (sliding window, ring-buffer KV)
and nemotron-4-340b (squared-ReLU MLP, layernorm), each at its SMOKE config.

Same weights (JAX init, the QKV biases redrawn from numpy so that they are
not zero, converted by ``checkpoint.jax_params_to_torch``), same numpy
inputs: prefill logits and every KV leaf, decode steps, the danube ring laid
out by prefill and wrapped twice by decode, the loss and its gradients, the
checkpoint round trip back into the JAX ``load_checkpoint``, a danube engine
batch whose TWEAK rows take the full prefill, and the train CLI.

Tolerance rtol/atol 1e-5 (the two frameworks' CPU matmuls and
transcendentals round differently, never by more); gradients within 1e-5 of
each leaf's largest |g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint
from repro.checkpoint.checkpoint import _flatten
from repro.core import TweakLLMEngine as JaxEngine
from repro.launch.serve import build_stack as jax_build_stack
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro_torch import configs
from repro_torch.checkpoint import (jax_params_to_torch, latest_checkpoint, save_checkpoint,
                                    torch_param_dtypes, torch_params_to_jax)
from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import value_and_grad
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2.5-3b", "deepseek-coder-33b", "h2o-danube-1.8b", "nemotron-4-340b"]


def _smoke(arch):
    return configs.get_config(arch, smoke=True)


def _pair(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same weights;
    QKV biases, which the reference initialises to zero, are redrawn."""
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = jp["scan"][0]["attn"]
        for name in ("b_q", "b_k", "b_v"):
            attn[name] = jnp.asarray(0.5 * rng.standard_normal(attn[name].shape),
                                     attn[name].dtype)
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _jax_cfg(cfg):
    return JaxModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _assert_caches(port, ref):
    jkv, pkv = ref["scan"][0], port["scan"][0]
    for leaf in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(pkv[leaf].numpy(), np.asarray(jkv[leaf]), **TOL)
    assert port["pos"] == int(ref["pos"])


def _decode_and_compare(jm, jp, pm, pp, jc, pc, rng, steps, vocab):
    for _ in range(steps):
        nxt = rng.integers(5, vocab, (jc["scan"][0]["k"].shape[1],)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(pc, jc)
    return jc, pc


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_build_and_keep_their_variant(arch):
    cfg = _smoke(arch)
    pp = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    attn, mlp = pp["layers"][0]["attn"], pp["layers"][0]["mlp"]
    assert ("b_qkv" in attn) == cfg.qkv_bias
    if cfg.qkv_bias:
        h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        assert attn["b_qkv"].shape == ((h + 2 * hk) * dh,) and not attn["b_qkv"].any()
    assert ("w_gate_up" in mlp) == (cfg.mlp_type == "swiglu")
    assert ("bias" in pp["layers"][0]["norm1"]) == (cfg.norm_type == "layernorm")
    caches = build_model(cfg).init_caches(2, 40, "cpu")
    ring = cfg.sliding_window if cfg.sliding_window else 40
    assert caches["scan"][0]["k"].shape[2] == min(40, ring)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg)
    rng = np.random.default_rng(1)
    b, s, cap = 3, 12, 12 + 5
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)
    _decode_and_compare(jm, jp, pm, pp, jc, pc, rng, 3, cfg.vocab_size)


def test_danube_ring_is_laid_out_by_prefill_and_wraps_twice_in_decode():
    """Window 16: a 20-token prompt into capacity 28 keeps a 16-slot ring,
    laid out by prefill in the reference's order (token j in slot j % 16),
    then 40 decode steps (positions 20..59) wrap it twice; logits and every
    KV leaf, ``slot_pos`` included, match the reference's at each step."""
    cfg = _smoke("h2o-danube-1.8b")
    assert cfg.sliding_window == 16
    jm, jp, pm, pp = _pair(cfg, seed=3)
    rng = np.random.default_rng(2)
    toks = rng.integers(5, cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 28)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, 28)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)
    sp = pc["scan"][0]["slot_pos"]
    assert sp.shape[-1] == 16
    assert sp[0, 0].tolist() == [16, 17, 18, 19] + list(range(4, 16))
    jc, pc = _decode_and_compare(jm, jp, pm, pp, jc, pc, rng, 40, cfg.vocab_size)
    assert pc["pos"] == 60
    assert sorted(pc["scan"][0]["slot_pos"][0, 0].tolist()) == list(range(44, 60))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 41)).astype(np.int32)
    mask = np.ones((3, 40), np.float32)
    mask[0, :7] = 0.0
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(jp)
    loss, _, grads = value_and_grad(pm, pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = jax_params_to_torch(_flatten(jgrads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    if cfg.qkv_bias:
        assert all(float(layer["attn"]["b_qkv"].abs().max()) > 0 for layer in grads["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_into_jax_load_checkpoint(arch, tmp_path):
    """Port params -> the reference's layout (biases as b_q/b_k/b_v, the
    squared-ReLU MLP's w_up/w_down, layernorm biases) -> JAX
    ``load_checkpoint``: every leaf exact, the JAX forward equal to the
    port's, and back through the converter unchanged."""
    cfg = _smoke(arch)
    jm, jp, pm, _ = _pair(cfg, seed=6)
    pp = pm.init(torch.Generator().manual_seed(7), "cpu")
    if cfg.qkv_bias:
        for layer in pp["layers"]:
            layer["attn"]["b_qkv"].normal_(generator=torch.Generator().manual_seed(8))
    flat = torch_params_to_jax(pp, cfg)
    assert set(flat) == set(_flatten(jp))
    save_checkpoint(str(tmp_path), 1, flat, {"arch": arch}, dtypes=torch_param_dtypes(pp, cfg))
    assert latest_checkpoint(str(tmp_path)) == 1
    restored, _ = load_checkpoint(str(tmp_path), 1, jp)
    back = jax_params_to_torch(_flatten(restored), cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pp)):
        assert torch.equal(a, b)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jm.forward(restored, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- engine

VOCAB, CAPACITY, THRESHOLD, MNT = 4096, 64, 0.96, 6


def _danube_small():
    """The danube smoke stack (window 16) as the tweak model, over the
    engine's 4,096-token vocabulary and with room for the tweak prompt."""
    return _smoke("h2o-danube-1.8b").replace(vocab_size=VOCAB, max_seq_len=1024)


@pytest.fixture(scope="module")
def danube_engines():
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    scfg = _danube_small()
    jsm = jax_build_model(_jax_cfg(scfg))
    jstack["small"] = JaxGenerator(jsm, jsm.init(jax.random.PRNGKey(2)), JaxGenerateConfig(
        max_new_tokens=16, sampler=JaxSamplerConfig(vocab_size=VOCAB)))
    big_cfg, _, ecfg, _ = model_configs("serve-tiny", VOCAB)
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name)
                                   for f in dataclasses.fields(cls)})
    gen_cfg = GenerateConfig(max_new_tokens=16, sampler=SamplerConfig(vocab_size=VOCAB))
    gens = [Generator(build_model(c),
                      jax_params_to_torch(_flatten(jstack[k].params), c, device="cpu"),
                      gen_cfg) for k, c in (("big", big_cfg), ("small", scfg))]
    peng = TweakLLMEngine(
        tokenizer=HashWordTokenizer(VOCAB),
        embedder_params=jax_params_to_torch(_flatten(jstack["embedder_params"]), ecfg,
                                            device="cpu"),
        embedder_cfg=ecfg, big=gens[0], small=gens[1],
        cache_cfg=pick(CacheConfig, jstack["cache_cfg"]),
        router_cfg=pick(RouterConfig, jstack["router_cfg"]))
    return JaxEngine(**jstack), peng


def test_danube_engine_batch_routes_tweak_through_the_full_prefill(danube_engines):
    """A windowed small model has no prefix path: both engines prefill the
    whole tweak prompt, longer than the 16-slot ring, and decode over the
    ring; routes, responses, stats and bank state agree."""
    jeng, peng = danube_engines
    assert not peng.small.supports_prefix_prefill and not peng._prefix_path_available()
    assert not jeng._prefix_path_available()
    g = QuestionPairGenerator(seed=4)
    cached = [g._random_query() for _ in range(4)]
    fresh = [g._random_query().text for _ in range(2)]
    pairs = ([q.text for q in cached],
             [synthesize_response(q.text, q.topic, q.intent) for q in cached])
    jeng.populate(*pairs)
    peng.populate(*pairs)
    batch = [cached[0].text, cached[1].text + " please", fresh[0], cached[2].text + " please",
             fresh[1], cached[3].text + " now"]
    jr, jm = jeng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
    pr, pm = peng.handle_batch(batch, max_new_tokens=MNT, collect_meta=True)
    for a, b in zip(pm, jm):
        assert min(abs(b["sim"] - THRESHOLD), abs(b["sim"] - 0.9999)) > 5e-5
        assert a["decision"] == b["decision"]
        assert a["gen_tokens"] == b["gen_tokens"]
    assert pr == jr
    assert {m["decision"] for m in pm} == {router.MISS, router.TWEAK, router.EXACT}
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    assert peng.stats.small_tokens > 0
    assert peng.bank.text_store == jeng.bank.text_store


def test_danube_generator_with_a_prompt_past_the_ring_matches_jax():
    """Greedy generation through the Generator's fused decode, the prompt
    (24 tokens) longer than the 16-slot ring: the same tokens as the
    reference's Generator."""
    cfg = _smoke("h2o-danube-1.8b")
    jm, jp, pm, pp = _pair(cfg, seed=11)
    toks = np.random.default_rng(12).integers(5, cfg.vocab_size, (3, 24)).astype(np.int32)
    jg = JaxGenerator(jm, jp, JaxGenerateConfig(
        max_new_tokens=10, sampler=JaxSamplerConfig(vocab_size=cfg.vocab_size)))
    pg = Generator(pm, pp, GenerateConfig(max_new_tokens=10,
                                          sampler=SamplerConfig(vocab_size=cfg.vocab_size)))
    jt, jn, _ = jg.generate_with_lengths({"tokens": jnp.asarray(toks)})
    pt, pn, _ = pg.generate_with_lengths({"tokens": toks})
    assert np.array_equal(np.asarray(pt), np.asarray(jt))
    assert np.array_equal(np.asarray(pn), np.asarray(jn))


# ---------------------------------------------------------------- train CLI

@pytest.mark.parametrize("arch", [None] + ARCHS[1:])
def test_train_cli_runs_each_arch_on_cpu(arch, capsys):
    """The train CLI's default (qwen2.5-3b, the reference's) and each other
    new id: exit 0 with the loss falling."""
    argv = ["--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64"]
    rc = train_cli.main(argv + ([] if arch is None else ["--arch", arch]))
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    assert out.startswith(f"arch={arch or 'qwen2.5-3b'} ")
