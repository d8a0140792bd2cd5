"""The MoE block of the port against the JAX package on the CPU, fp32:
``models.moe.apply_moe`` (GShard top-k capacity dispatch, the load-balance
loss, Arctic's dense residual) and the two MoE stacks, arctic-480b and
qwen3-moe-235b-a22b, at their SMOKE configs.

Same weights (JAX init, converted by ``checkpoint.jax_params_to_torch``),
same numpy inputs: the layer's output and aux, with the kept (token,
choice) set equal to the reference's; prefill logits and every KV leaf,
decode steps, a K-4 verify block, paged and speculative generation, the
prefix (TWEAK) prefill, the loss and its gradients, the checkpoint round
trip back into the JAX ``load_checkpoint`` (a bf16 copy too, whose router
stays fp32), an engine batch with the qwen3-moe smoke model as the small LM,
and the train CLI.

A MOE block's output depends on the other tokens of its dispatch group, so
each check feeds both frameworks the same groups.  Tolerance rtol/atol 1e-5;
gradients within 1e-5 of each leaf's largest |g|.
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
from repro.models import moe as jax_moe
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro.serving import paged_kv as jax_paged_kv
from repro_torch import configs
from repro_torch.checkpoint import (jax_params_to_torch, save_checkpoint, torch_param_dtypes,
                                    torch_params_to_jax)
from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.serving import paged_kv
from repro_torch.serving.continuous import leaked_pages
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import value_and_grad
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]


def _smoke(arch):
    return configs.get_config(arch, smoke=True)


def _jax_cfg(cfg):
    return JaxModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _pair(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _jax_kept(jp_moe, x, cfg):
    """The reference's kept (token, choice) mask, (G, S_g, k): its own
    ``router_topk`` and ``_capacity`` and the cumsum rank of
    ``moe.py:85-90``, on its own grouping."""
    b, s, d = x.shape
    n = b * s
    gsz = min(cfg.moe_group_size, n)
    pad = (-n) % gsz
    xf = jnp.concatenate([x.reshape(n, d), jnp.zeros((pad, d), x.dtype)])
    xg = xf.reshape(-1, gsz, d)
    _, topi, _ = jax_moe.router_topk(jp_moe, xg, cfg)
    onehot = jax.nn.one_hot(topi, cfg.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(xg.shape[0], gsz * cfg.experts_per_token, cfg.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1).reshape(topi.shape)
    return np.asarray(pos < jax_moe._capacity(cfg, gsz)), np.asarray(topi)


def _port_moe(jp):
    """The port's layout of one reference MoE layer: gate | up fused."""
    t = lambda a: torch.from_numpy(np.array(a))
    swiglu = lambda m: {"w_gate_up": torch.cat([t(m["w_gate"]), t(m["w_up"])], dim=-1),
                        "w_down": t(m["w_down"])}
    p = {"router": t(jp["router"]), **swiglu(jp)}
    if "dense" in jp:
        p["dense"] = swiglu(jp["dense"])
    return p


# (arch, group size, batch, seq, capacity factor): capacity loose; capacity
# binding (cf 1.0 at 64 tokens: C 32 against a mean load of 32); several
# groups of 16 with a padded last group; Arctic's dense residual
MOE_CASES = {"loose": ("qwen3-moe-235b-a22b", 2048, 2, 12, None),
             "binding": ("qwen3-moe-235b-a22b", 2048, 4, 16, 1.0),
             "groups-padded": ("qwen3-moe-235b-a22b", 16, 3, 13, None),
             "dense-residual": ("arctic-480b", 2048, 4, 16, 1.0)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax(case):
    arch, gsz, b, s, cf = MOE_CASES[case]
    cfg = _smoke(arch).replace(moe_group_size=gsz)
    if cf is not None:
        cfg = cfg.replace(capacity_factor=cf)
    jcfg = _jax_cfg(cfg)
    jp = jax_moe.init_moe(jax.random.PRNGKey(len(case)), jcfg)
    pp = _port_moe(jp)
    assert ("dense" in pp) == cfg.moe_dense_residual == (case == "dense-residual")
    x = np.random.default_rng(len(case)).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    want, want_aux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    kept, topi = _jax_kept(jp, jnp.asarray(x), jcfg)
    g = kept.shape[0]
    xf, _, idx, rank, cap, _ = moe.route(pp, torch.from_numpy(x), cfg)
    assert xf.shape == (g * kept.shape[1], cfg.d_model) and cap == jax_moe._capacity(jcfg, kept.shape[1])
    assert np.array_equal(idx.numpy(), topi)
    assert np.array_equal((rank < cap).numpy(), kept)
    if case in ("binding", "dense-residual"):
        assert not kept.all(), "capacity should drop a pair here"
    if case == "groups-padded":
        assert g == 3 and g * 16 > b * s
        # the zero pad rows tie at logit 0 and route to experts 0..k-1
        assert (topi[-1, -1] == np.arange(cfg.experts_per_token)).all()


def test_capacity_is_the_reference_arithmetic():
    for arch in ARCHS:
        for full in (False, True):
            cfg = configs.get_config(arch, smoke=not full)
            jcfg = _jax_cfg(cfg)
            for n in (1, 4, 8, 13, 32, 64, 100, 512, 2048):
                assert moe.capacity(cfg, n) == jax_moe._capacity(jcfg, n)
    full = configs.get_config("qwen3-moe-235b-a22b")
    assert moe.capacity(full, 512) == 40 and moe.capacity(full, 4) == 8
    assert moe.capacity(configs.get_config("arctic-480b"), 512) == 16


def test_expert_ranks_follow_the_flattened_pair_order():
    """Token s's second choice ranks before token s+1's first in the same
    expert; ranks count from 0 within each (group, expert)."""
    idx = torch.tensor([[[0, 1], [1, 0], [1, 2]], [[2, 0], [0, 2], [2, 1]]])
    assert moe.expert_ranks(idx, 3).tolist() == [[[0, 0], [1, 1], [2, 0]],
                                                 [[0, 0], [1, 1], [2, 0]]]


# ---------------------------------------------------------------- the stacks

def _assert_caches(port, ref):
    jkv, pkv = ref["scan"][0], port["scan"][0]
    for leaf in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(pkv[leaf].numpy(), np.asarray(jkv[leaf]), **TOL)
    assert port["pos"] == int(ref["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_verify_block_match_jax(arch):
    """Prefill of 3 x 24 tokens (one group of 72; qwen3-moe's smoke capacity
    48 against a mean load of 36), 3 decode steps, then a K-4 verify block
    on per-row positions: logits and every KV leaf."""
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg)
    rng = np.random.default_rng(1)
    b, s, cap = 3, 24, 24 + 8
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)
    for _ in range(3):
        nxt = rng.integers(5, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(pc, jc)
    blk = rng.integers(5, cfg.vocab_size, (b, 4)).astype(np.int32)
    jl, jc = jm.decode_block(jp, jnp.asarray(blk), jax_paged_kv.row_pos_caches(jc, b))
    pl, pc = pm.decode_block(pp, torch.from_numpy(blk), paged_kv.row_pos_caches(pc, b))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for leaf in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(pc["scan"][0][leaf].numpy(),
                                   np.asarray(jc["scan"][0][leaf]), **TOL)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))


def test_moe_models_take_every_serving_path():
    cfg = _smoke("qwen3-moe-235b-a22b")
    pm = build_model(cfg)
    assert pm.supports_paged_decode and pm.supports_spec_decode
    assert not pm.supports_prefix_prefill          # "auto" attention, as the reference's
    assert build_model(cfg.replace(attention_impl="xla_flash")).supports_prefix_prefill
    jm = jax_build_model(_jax_cfg(cfg))
    assert (jm.supports_paged_decode, jm.supports_spec_decode) == (True, True)


def _generators(arch, seed, **kw):
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg, seed=seed)
    common = dict(max_new_tokens=8, eos_id=2, **kw)
    jg = JaxGenerator(jm, jp, JaxGenerateConfig(
        sampler=JaxSamplerConfig(vocab_size=cfg.vocab_size), **common))
    pg = Generator(pm, pp, GenerateConfig(sampler=SamplerConfig(vocab_size=cfg.vocab_size),
                                          **common))
    toks = np.random.default_rng(seed + 1).integers(5, cfg.vocab_size, (3, 10))
    return jg, pg, toks.astype(np.int32)


def _assert_same(got, want):
    for a, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_generation_matches_jax(arch):
    """Greedy generation through the Generator over a page pool (pages of
    4) against the reference's: the same tokens and lengths, no page
    leaked."""
    jg, pg, toks = _generators(arch, 2, paged=True, page_size=4)
    _assert_same(pg.generate_with_lengths({"tokens": toks}),
                 jg.generate_with_lengths({"tokens": jnp.asarray(toks)}))
    assert pg.pool.live_pages == 0 and leaked_pages(pg) == 0


def test_speculative_generation_matches_jax():
    """The speculative verify loop (K 4) of qwen3-moe with drafts (one row's
    draft diverging, one row without) against the reference's: tokens,
    lengths and acceptance counters."""
    jg, pg, toks = _generators("qwen3-moe-235b-a22b", 2, spec_k=4)
    drafts = np.asarray(jg.generate_with_lengths({"tokens": jnp.asarray(toks)})[0]).copy()
    drafts[1, 3:] = 7
    drafts = (drafts, np.array([8, 8, 0], np.int32))
    _assert_same(pg.generate_with_lengths({"tokens": toks}, drafts=drafts),
                 jg.generate_with_lengths({"tokens": jnp.asarray(toks)}, drafts=drafts))
    assert pg.last_spec_stats == jg.last_spec_stats and pg.last_spec_stats["accepted"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """Loss = CE + the summed load-balance losses; every leaf's gradient
    (the fp32 router's through the routing probabilities and aux)."""
    cfg = _smoke(arch)
    jm, jp, pm, pp = _pair(cfg, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 33)).astype(np.int32)
    mask = np.ones((3, 32), np.float32)
    mask[0, :7] = 0.0
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(jp)
    loss, met, grads = value_and_grad(pm, pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), **TOL)
    assert float(met["aux"]) > 0
    want = jax_params_to_torch(_flatten(jgrads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_into_jax_load_checkpoint(arch, tmp_path):
    """Port params -> the reference's layout (``moe/router``, ``w_gate``,
    ``w_up``, ``w_down``, Arctic's ``moe/dense``) -> JAX ``load_checkpoint``:
    every leaf exact, the JAX forward equal to the port's; then a bf16 copy,
    whose router stays fp32 in both frameworks."""
    cfg = _smoke(arch)
    jm, jp, pm, _ = _pair(cfg, seed=6)
    pp = pm.init(torch.Generator().manual_seed(7), "cpu")
    flat = torch_params_to_jax(pp, cfg)
    assert set(flat) == set(_flatten(jp))
    save_checkpoint(str(tmp_path / "f32"), 1, flat, {"arch": arch},
                    dtypes=torch_param_dtypes(pp, cfg))
    restored, _ = load_checkpoint(str(tmp_path / "f32"), 1, jp)
    back = jax_params_to_torch(_flatten(restored), cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pp)):
        assert torch.equal(a, b)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, want_aux = jm.forward(restored, {"tokens": jnp.asarray(toks)})
    got, aux = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    bf = cfg.replace(dtype="bfloat16")
    jbf = jax_build_model(_jax_cfg(bf)).init(jax.random.PRNGKey(0))
    pbf = build_model(bf).init(torch.Generator().manual_seed(7), "cpu")
    router_leaf = pbf["layers"][0]["moe"]["router"]
    assert router_leaf.dtype == torch.float32
    assert pbf["layers"][0]["moe"]["w_gate_up"].dtype == torch.bfloat16
    dtypes = torch_param_dtypes(pbf, bf)
    assert dtypes["scan/0/moe/router"] == "float32" and dtypes["scan/0/moe/w_up"] == "bfloat16"
    save_checkpoint(str(tmp_path / "bf16"), 2, torch_params_to_jax(pbf, bf), {"arch": arch},
                    dtypes=dtypes)
    restored, _ = load_checkpoint(str(tmp_path / "bf16"), 2, jbf)
    assert restored["scan"][0]["moe"]["router"].dtype == jnp.float32
    assert restored["scan"][0]["moe"]["w_gate"].dtype == jnp.bfloat16
    back = jax_params_to_torch(_flatten(restored), bf, device="cpu")
    assert back["layers"][0]["moe"]["router"].dtype == torch.float32
    for a, b in zip(tree_leaves(back), tree_leaves(pbf)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- engine

VOCAB, CAPACITY, THRESHOLD, MNT = 4096, 64, 0.96, 6


@pytest.fixture(scope="module")
def moe_engines():
    """The tiny stack with the qwen3-moe smoke model as the small (tweak) LM,
    on xla_flash attention, so TWEAK rows take the prefix prefill."""
    jstack = jax_build_stack(vocab=VOCAB, capacity=CAPACITY, train_embedder_steps=0,
                             threshold=THRESHOLD)
    scfg = _smoke("qwen3-moe-235b-a22b").replace(
        vocab_size=VOCAB, max_seq_len=1024, attention_impl="xla_flash", flash_block_q=32,
        flash_block_k=32)
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


def test_engine_batch_with_a_moe_tweak_model_matches_jax(moe_engines):
    """TWEAK rows prefill their suffix over the shared prefix on the MoE
    small model; routes, responses, stats and bank state agree."""
    jeng, peng = moe_engines
    assert peng._prefix_path_available() and jeng._prefix_path_available()
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


# ---------------------------------------------------------------- train CLI

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_moe_arch_on_cpu(arch, capsys):
    """exit 0 with the loss (CE + aux) falling."""
    argv = ["--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64", "--arch", arch]
    rc = train_cli.main(argv)
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    assert out.startswith(f"arch={arch} ")
