"""The recurrent stacks of the port against the JAX package on the CPU,
fp32: mamba2-130m (24 x MAMBA2 at full size; its SMOKE config is 2 layers,
chunk 16) and recurrentgemma-9b (RGLRU, RGLRU, LOCAL_ATTN periods plus an
(RGLRU, RGLRU) remainder; its SMOKE config is one period and the remainder,
window 16), each at its SMOKE config.

Same weights (JAX init, converted by ``checkpoint.jax_params_to_torch``),
same numpy inputs: prefill logits and every cache leaf (``scan[j]`` stacked
over the periods, ``rem[i]``, ``pos``, the local attention's ring laid out
once the prompt passes the window), decode steps, the loss and its
gradients, greedy tokens of the ``Generator`` (fused and host-loop) against
the reference's, the checkpoint round trip both ways, the capability flags
of every id, an engine batch with the mamba2 stack as the TWEAK model, and
the train CLI.

Tolerance rtol/atol 1e-5 (the two frameworks' CPU matmuls, transcendentals
and scan orders round differently, never by more); gradients within 1e-4
of each leaf's largest |g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint
from repro.checkpoint.checkpoint import _flatten
from repro.configs import get_config as jax_get_config
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
from repro_torch.models.transformer import attention_layers, layer_slots
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import value_and_grad
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mamba2-130m", "recurrentgemma-9b"]


def _smoke(arch):
    return configs.get_config(arch, smoke=True)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _assert_caches(port, ref):
    """Every leaf of every ``scan[j]`` and ``rem[i]`` cache, and ``pos``."""
    assert len(port["scan"]) == len(ref["scan"]) and len(port["rem"]) == len(ref["rem"])
    for got, want in zip(port["scan"] + port["rem"], ref["scan"] + ref["rem"]):
        for leaf, t in got.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[leaf]), **TOL, err_msg=leaf)
    assert port["pos"] == int(ref["pos"])


def test_layer_order_and_cache_layout():
    """recurrentgemma-9b: 12 periods of (RGLRU, RGLRU, LOCAL_ATTN), then the
    (RGLRU, RGLRU) remainder; the ring of its local attention holds the
    window, 2,048 slots, whatever the capacity past it."""
    cfg = configs.get_config("recurrentgemma-9b")
    slots = layer_slots(cfg)
    assert len(slots) == 38 and slots[2] == ("local_attn", "scan", 2, 0)
    assert slots[35] == ("local_attn", "scan", 2, 11)
    assert slots[36:] == (("rglru", "rem", 0, None), ("rglru", "rem", 1, None))
    caches = build_model(cfg).init_caches(4, 4096, "meta")
    assert caches["scan"][2]["k"].shape == (12, 4, 2048, 1, 256)
    assert caches["scan"][0]["h"].shape == (12, 4, 4096)
    assert caches["rem"][1]["conv"].shape == (4, 3, 4096)
    mamba = configs.get_config("mamba2-130m")
    assert [s[1:] for s in layer_slots(mamba)] == [("scan", 0, i) for i in range(24)]
    assert attention_layers(cfg) == 12 and attention_layers(mamba) == 0
    assert attention_layers(configs.get_config("llama-3.1-8b")) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """A 21-token prompt (mamba2: front-padded to two chunks of 16;
    recurrentgemma: past its 16-slot ring) then 10 decode steps, every
    cache leaf compared after each."""
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg)
    rng = np.random.default_rng(1)
    b, s, cap = 3, 21, 32
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, {"tokens": jnp.asarray(toks)}, cap)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)
    if cfg.sliding_window:      # token j in slot j % 16, the last 16 tokens kept
        sp = pc["scan"][2]["slot_pos"]
        assert sp.shape == (1, b, 16)
        assert sp[0, 0].tolist() == [16, 17, 18, 19, 20] + list(range(5, 16))
    step = jax.jit(jm.decode_step)
    for _ in range(10):
        nxt = rng.integers(5, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(pc, jc)
    assert pc["pos"] == s + 10


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    mask = np.ones((2, 40), np.float32)
    mask[0, :7] = 0.0
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True))(jp)
    loss, _, grads = value_and_grad(pm, pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = jax_params_to_torch(_flatten(jgrads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_matches_jax_fused_and_host_loop(arch):
    """Greedy generation of 12 tokens from 3 prompts of 20 (past the ring
    for recurrentgemma): the reference's Generator's tokens and lengths,
    from the port's fused decode and from its host loop alike."""
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg, seed=11)
    toks = np.random.default_rng(12).integers(5, cfg.vocab_size, (3, 20)).astype(np.int32)
    sampler = SamplerConfig(vocab_size=cfg.vocab_size)
    jg = JaxGenerator(jm, jp, JaxGenerateConfig(
        max_new_tokens=12, sampler=JaxSamplerConfig(vocab_size=cfg.vocab_size)))
    pg = Generator(pm, pp, GenerateConfig(max_new_tokens=12, sampler=sampler))
    jt, jn, _ = jg.generate_with_lengths({"tokens": jnp.asarray(toks)})
    for fused in (True, False):
        pt, pn, _ = pg.generate_with_lengths({"tokens": toks}, fused=fused)
        assert np.array_equal(np.asarray(pt), np.asarray(jt)), fused
        assert np.array_equal(np.asarray(pn), np.asarray(jn)), fused


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_into_jax_load_checkpoint(arch, tmp_path):
    """Port params -> the reference's ``scan/<j>`` and ``rem/<i>`` layout ->
    JAX ``load_checkpoint``: every leaf exact, the JAX forward equal to the
    port's, and back through the converter unchanged; in a bf16 copy the
    SSM's and RG-LRU's fp32 leaves stay fp32."""
    cfg = _smoke(arch)
    jm, jp, pm, _ = _pair(cfg, seed=6)
    pp = pm.init(torch.Generator().manual_seed(7), "cpu")
    flat = torch_params_to_jax(pp, cfg)
    assert set(flat) == set(_flatten(jp))
    assert all(flat[k].shape == np.asarray(v).shape for k, v in _flatten(jp).items())
    save_checkpoint(str(tmp_path), 1, flat, {"arch": arch}, dtypes=torch_param_dtypes(pp, cfg))
    assert latest_checkpoint(str(tmp_path)) == 1
    restored, _ = load_checkpoint(str(tmp_path), 1, jp)
    back = jax_params_to_torch(_flatten(restored), cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pp)):
        assert torch.equal(a, b)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(restored, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    bcfg = cfg.replace(dtype="bfloat16")
    half = jax_params_to_torch(flat, bcfg, device="cpu")
    dtypes = torch_param_dtypes(half, bcfg)
    fp32 = {"a_log", "d_skip", "dt_bias", "w_a", "b_a", "w_i", "b_i", "lam", "scale"}
    for path, name in dtypes.items():
        leaf = path.split("/")[-1]
        assert name == ("float32" if leaf in fp32 else "bfloat16"), path


@pytest.mark.parametrize("smoke", [False, True])
def test_capability_flags_match_the_reference(smoke):
    """``supports_prefix_prefill``, ``supports_paged_decode`` and
    ``supports_spec_decode`` of every id the port builds equal the
    reference ``Model``'s; the recurrent ids report False for all three."""
    for arch in sorted(configs._MODULES):
        cfg = configs.get_config(arch, smoke)
        pm, jm = build_model(cfg), jax_build_model(jax_get_config(arch, smoke))
        for flag in ("supports_prefix_prefill", "supports_paged_decode",
                     "supports_spec_decode"):
            assert getattr(pm, flag) == getattr(jm, flag), (arch, flag)
            if arch in ARCHS:
                assert not getattr(pm, flag)


def test_recurrent_stacks_refuse_the_kv_only_paths():
    """No prefix prefill, no verify block and no per-row positions for a
    recurrent stack, as in the reference: the callers use the full prefill
    and the dense decode step."""
    cfg = _smoke("mamba2-130m")
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(5, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError):
        pm.prefill_prefix(pp, toks)
    with pytest.raises(NotImplementedError):
        pm.decode_block(pp, toks[:, :2], None)
    _, caches = pm.prefill(pp, {"tokens": toks}, 16)
    with pytest.raises(ValueError, match="host-int pos"):
        pm.decode_step(pp, toks[:, 0], dict(caches, pos=torch.full((2,), 8)))
    with pytest.raises(ValueError):
        Generator(pm, pp, GenerateConfig(max_new_tokens=4, spec_k=2))


# ---------------------------------------------------------------- engine

VOCAB, CAPACITY, THRESHOLD, MNT = 4096, 64, 0.96, 6


@pytest.fixture(scope="module")
def mamba_engines():
    """The reference's serve stack and the port's, with the mamba2 smoke
    stack (over the engine's 4,096-token vocabulary) as the TWEAK model."""
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    scfg = _smoke("mamba2-130m").replace(vocab_size=VOCAB, max_seq_len=1024)
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


def test_mamba_engine_batch_routes_tweak_through_the_full_prefill(mamba_engines):
    """A recurrent small model has no prefix path: both engines prefill the
    whole tweak prompt and decode over the SSM state, and make no prefix
    cache; routes, responses, stats and bank state agree."""
    jeng, peng = mamba_engines
    assert not peng.small.supports_prefix_prefill and not peng._prefix_path_available()
    assert not jeng._prefix_path_available()
    g = QuestionPairGenerator(seed=5)
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
    assert peng.stats.small_tokens > 0 and not peng._prefix_caches
    assert peng.bank.text_store == jeng.bank.text_store


# ---------------------------------------------------------------- train CLI

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_recurrent_arch_on_cpu(arch, capsys):
    """``--arch mamba2-130m`` and ``--arch recurrentgemma-9b``: exit 0 with
    the loss falling."""
    rc = train_cli.main(["--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64",
                         "--arch", arch])
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    assert out.startswith(f"arch={arch} ")
