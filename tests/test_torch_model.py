"""Port model layer against the JAX package on the CPU, fp32.

Same weights (JAX init, converted by ``repro_torch.checkpoint``), same
numpy inputs: prefill logits and every KV leaf, decode steps, a prefix
prefill at P=45, the embedder, and the decode mask equivalence the port's
kernel relies on.  Tolerance rtol/atol 1e-5: the two frameworks' CPU
matmuls and transcendentals round differently, never by more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import save_checkpoint
from repro.checkpoint.checkpoint import _flatten
from repro.configs import llama31_8b as jax_llama
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import embedder as jax_embedder
from repro_torch import configs as port_configs
from repro_torch.checkpoint import jax_params_to_torch, read_checkpoint
from repro_torch.configs import llama31_8b
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import embedder as port_embedder
from repro_torch.models.attention import decode_attention
from repro_torch.launch.serve import model_configs
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(cfg: ModelConfig, seed: int = 0):
    """(jax model, jax params, port model, port params) for one config."""
    jcfg = JaxModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _configs():
    big, small, _, _ = model_configs("serve-tiny", vocab=512)
    smoke = llama31_8b.SMOKE_CONFIG
    return {"tiny-big": big, "tiny-small": small, "llama-smoke": smoke,
            "llama-smoke-flash": smoke.replace(attention_impl="xla_flash",
                                               flash_block_q=32, flash_block_k=32)}


CONFIGS = _configs()


def _assert_caches(port, ref):
    jkv, pkv = ref["scan"][0], port["scan"][0]
    for leaf in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(pkv[leaf].numpy(), np.asarray(jkv[leaf]), **TOL)
    assert port["pos"] == int(ref["pos"])
    assert np.all(np.asarray(jkv["pos"]) == port["pos"])   # per-layer copies
    assert ref["rem"] == () and port["rem"] == ()


@pytest.mark.parametrize("arch", ["llama-3.1-8b", "qwen2.5-3b", "deepseek-coder-33b",
                                  "h2o-danube-1.8b", "nemotron-4-340b", "arctic-480b",
                                  "qwen3-moe-235b-a22b"])
def test_config_copies_match_reference(arch):
    port, ref = port_configs.get_arch(arch), jax_configs.get_arch(arch)
    assert port.CONFIG.__dict__ == ref.CONFIG.__dict__
    assert port.SMOKE_CONFIG.__dict__ == ref.SMOKE_CONFIG.__dict__
    assert port.SKIP_SHAPES == ref.SKIP_SHAPES
    assert port.CONFIG.padded_vocab == ref.CONFIG.padded_vocab
    assert port_embedder.MINILM_CONFIG.__dict__ == jax_embedder.MINILM_CONFIG.__dict__
    if arch == "llama-3.1-8b":
        assert port.CONFIG is llama31_8b.CONFIG and ref.CONFIG is jax_llama.CONFIG
        assert llama31_8b.CONFIG.padded_vocab == llama31_8b.CONFIG.vocab_size == 128256


def test_convert_round_trip_through_checkpoint(tmp_path):
    """JAX params -> npz+msgpack -> port reader -> port params: every port
    tensor is the JAX leaf it came from, reshaped."""
    cfg = CONFIGS["tiny-small"]
    _, jp, _, _ = _pair(cfg)
    save_checkpoint(str(tmp_path), 3, jp, metadata={"name": cfg.name})
    flat, meta = read_checkpoint(str(tmp_path), 3)
    assert meta["step"] == 3 and meta["metadata"]["name"] == cfg.name
    p = jax_params_to_torch(flat, cfg, device="cpu")
    jl = jp["scan"][0]
    h, hk, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    for i, layer in enumerate(p["layers"]):
        wq, wk, wv = layer["attn"]["w_qkv"].split([h * dh, hk * dh, hk * dh], dim=-1)
        for name, w, heads in (("w_q", wq, h), ("w_k", wk, hk), ("w_v", wv, hk)):
            assert np.array_equal(w.reshape(d, heads, dh).numpy(),
                                  np.asarray(jl["attn"][name][i]))
        assert np.array_equal(layer["attn"]["w_o"].reshape(h, dh, d).numpy(),
                              np.asarray(jl["attn"]["w_o"][i]))
        g, u = layer["mlp"]["w_gate_up"].chunk(2, dim=-1)
        assert np.array_equal(g.numpy(), np.asarray(jl["mlp"]["w_gate"][i]))
        assert np.array_equal(u.numpy(), np.asarray(jl["mlp"]["w_up"][i]))
        assert np.array_equal(layer["mlp"]["w_down"].numpy(), np.asarray(jl["mlp"]["w_down"][i]))
        assert np.array_equal(layer["norm1"]["scale"].numpy(), np.asarray(jl["norm1"]["scale"][i]))
    for name in ("embed", "lm_head"):
        assert np.array_equal(p[name].numpy(), np.asarray(jp[name]))


def test_convert_keeps_bf16_weights_and_fp32_norms():
    cfg = CONFIGS["llama-smoke"].replace(dtype="bfloat16")
    _, jp, _, p = _pair(cfg)
    assert p["layers"][0]["attn"]["w_qkv"].dtype == torch.bfloat16
    assert p["layers"][0]["norm1"]["scale"].dtype == torch.float32
    ref = np.asarray(jp["embed"]).astype(np.float32)
    assert np.array_equal(p["embed"].float().numpy(), ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    cfg = CONFIGS[name]
    jm, jp, pm, pp = _pair(cfg)
    rng = np.random.default_rng(0)
    b, s, cap, steps = 2, 20, 28, 3
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cap)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)
    for _ in range(steps):
        nxt = rng.integers(5, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(pc, jc)


@pytest.mark.parametrize("name", ["tiny-small", "llama-smoke-flash"])
@pytest.mark.parametrize("b,s", [(1, 16), (4, 32)])
def test_prefix_prefill_matches_jax(name, b, s):
    """Suffix prefill over a 45-token prefix: the port against the JAX
    package's own prefix path."""
    cfg = CONFIGS[name]
    jm, jp, pm, pp = _pair(cfg)
    rng = np.random.default_rng(b + s)
    p = 45
    pre = np.broadcast_to(rng.integers(5, cfg.vocab_size, (1, p)), (b, p)).astype(np.int32)
    suf = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    cap = p + s + 9
    jpre = jm.prefill_prefix(jp, jnp.asarray(pre))
    jl, jc = jm.prefill_with_prefix(jp, {"tokens": jnp.asarray(suf)}, cap, jpre)
    ppre = pm.prefill_prefix(pp, torch.from_numpy(pre).long())
    _assert_caches(ppre, jpre)
    pl, pc = pm.prefill_with_prefix(pp, {"tokens": torch.from_numpy(suf).long()}, cap, ppre)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(pc, jc)


@pytest.mark.parametrize("b,p,s", [(1, 45, 16), (4, 45, 32), (4, 7, 128)])
def test_prefix_prefill_equals_full_prefill_in_port(b, p, s):
    """Within the port on the CPU, prefix reuse is bitwise the inline prefill
    (fixed flash blocks + row-independent CPU matmuls)."""
    cfg = CONFIGS["tiny-small"]
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(b * p + s)
    pre = torch.randint(5, cfg.vocab_size, (1, p), generator=g).expand(b, p)
    suf = torch.randint(5, cfg.vocab_size, (b, s), generator=g)
    cap = p + s + 9
    lf, cf = pm.prefill(pp, {"tokens": torch.cat([pre, suf], 1)}, cap)
    lp, cp = pm.prefill_with_prefix(pp, {"tokens": suf}, cap, pm.prefill_prefix(pp, pre))
    assert torch.equal(lf, lp)
    for leaf in ("k", "v", "slot_pos"):
        assert torch.equal(cf["scan"][0][leaf], cp["scan"][0][leaf])
    assert cf["pos"] == cp["pos"]


def test_embedder_matches_jax():
    ecfg = port_embedder.tiny_embedder_config(512)
    jecfg = jax_embedder.tiny_embedder_config(512)
    jp = jax_embedder.init_embedder(jax.random.PRNGKey(0), jecfg)
    pp = jax_params_to_torch(_flatten(jp), ecfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(5, 512, (4, 16)).astype(np.int32)
    mask = np.zeros((4, 16), np.float32)
    for i, n in enumerate((16, 9, 3, 1)):
        mask[i, :n] = 1
    ref = np.asarray(jax_embedder.encode(jp, jnp.asarray(toks), jnp.asarray(mask), jecfg))
    out = port_embedder.encode(pp, torch.from_numpy(toks).long(), torch.from_numpy(mask),
                               ecfg).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)
    assert np.all(np.sum(out * ref, axis=-1) >= 1 - 1e-6)


def test_decode_mask_is_cache_len_pos_plus_one():
    """The reference masks decode with ``slot_pos >= 0 & slot_pos <= pos``
    after writing the token at slot ``pos``; on a prefilled dense cache
    that is ``t < pos + 1``, the mask the port's kernel takes.  A windowed
    ring of ``cap`` slots adds ``slot_pos > pos - window``, and the mask
    is ``t < min(pos + 1, cap)`` before and after the ring wraps, also
    when prefill laid out a prompt longer than the ring; a paged cache
    refuses a window."""
    cfg = CONFIGS["tiny-big"]
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(5, cfg.vocab_size, (3, 11))
    _, caches = pm.prefill(pp, {"tokens": toks}, 11 + 6)
    for _ in range(4):
        pos = caches["pos"]
        _, caches = pm.decode_step(pp, torch.randint(5, cfg.vocab_size, (3,)), caches)
        slot_pos = caches["scan"][0]["slot_pos"]
        ref_mask = (slot_pos >= 0) & (slot_pos <= pos)
        t = torch.arange(slot_pos.shape[-1])
        assert torch.equal(ref_mask, (t < pos + 1).expand_as(ref_mask))
    wcfg = cfg.replace(sliding_window=8)
    wm = build_model(wcfg)
    for prompt, capacity in ((5, 7), (5, 40), (13, 40)):
        _, caches = wm.prefill(pp, {"tokens": toks[:, :prompt]}, capacity)
        cap = caches["scan"][0]["k"].shape[2]
        assert cap == min(capacity, 8)
        for _ in range(12):
            pos = caches["pos"]
            _, caches = wm.decode_step(pp, torch.randint(5, cfg.vocab_size, (3,)), caches)
            slot_pos = caches["scan"][0]["slot_pos"]
            ref_mask = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - 8)
            t = torch.arange(cap)
            assert torch.equal(ref_mask, (t < min(pos + 1, cap)).expand_as(ref_mask))
    with pytest.raises(NotImplementedError):
        decode_attention(pp["layers"][0]["attn"], torch.zeros(3, 1, cfg.d_model),
                         {"kp": None}, 0, caches["pos"], None, cfg, window=8)
