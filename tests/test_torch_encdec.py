"""The encoder-decoder of the port (``models/encdec.py``) against the JAX
package's on the CPU, fp32: whisper-tiny's SMOKE config (QKV bias,
layernorm, gelu, 16 frames) and the encoder-decoder of the reference's
system test (no bias, 8 frames).

Same weights (JAX init, the QKV biases redrawn from numpy so that they are
not zero, converted by ``checkpoint.jax_params_to_torch``), same numpy
frames and tokens: ``encode``, the forward logits, the loss, prefill (logits
and every cache leaf: the self KV, ``cross_k``, ``cross_v``), three decode
steps, greedy ``Generator`` tokens, one train step's gradients, the
sinusoidal rows up to whisper's last position, the capability flags, the
checkpoint round trip and the train CLI.

Tolerance rtol/atol 1e-5 (the two frameworks' CPU matmuls and
transcendentals round differently, never by more); gradients within 1e-4
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
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.layers import sinusoidal_positions as jax_sinusoidal_positions
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro_torch import configs
from repro_torch.checkpoint import (jax_params_to_torch, save_checkpoint, torch_param_dtypes,
                                    torch_params_to_jax)
from repro_torch.launch import train as train_cli
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import encdec
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import value_and_grad
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)
# the encoder-decoder of tests/test_system.py::test_decode_matches_forward_encdec
SYSTEM = ModelConfig(family="encdec", num_layers=2, enc_layers=2, d_model=64, num_heads=4,
                     num_kv_heads=4, d_ff=128, vocab_size=256, mlp_type="gelu",
                     norm_type="layernorm", enc_frames=8, max_seq_len=64,
                     tie_embeddings=True, dtype="float32")
CFGS = {"whisper-smoke": configs.get_config("whisper-tiny", smoke=True), "system": SYSTEM}


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    """(cfg, jax model, jax params, port model, port params) on the same
    weights; QKV biases, which the reference initialises to zero, redrawn."""
    cfg = CFGS[request.param]
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    if cfg.qkv_bias:
        rng = np.random.default_rng(100)
        for group, key in (("enc_scan", "attn"), ("dec_scan", "self_attn"),
                           ("dec_scan", "cross_attn")):
            attn = jp[group][key]
            for name in ("b_q", "b_k", "b_v"):
                attn[name] = jnp.asarray(0.5 * rng.standard_normal(attn[name].shape),
                                         attn[name].dtype)
    return cfg, _Jitted(jm), jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg,
                                                                      device="cpu")


class _Jitted:
    """The JAX model's entry points under ``jax.jit`` (the eager scans
    compile on every call: 3x slower)."""

    def __init__(self, jm):
        self.model, self.cfg = jm, jm.cfg
        self.forward = jax.jit(jm.forward)
        self.prefill = jax.jit(jm.prefill, static_argnums=2)
        self.decode_step = jax.jit(jm.decode_step)
        self.encode = jax.jit(lambda p, f: jax_encdec.encode(p, f, jm.cfg))
        self.grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, toks


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


def _assert_caches(port, ref):
    for leaf in ("k", "v", "slot_pos"):
        _close(port["self"][leaf], ref["self"][leaf], err_msg=leaf)
    _close(port["cross_k"], ref["cross_k"])
    _close(port["cross_v"], ref["cross_v"])
    assert port["pos"] == int(ref["pos"])


def test_encode_forward_and_loss_match_jax(pair):
    cfg, jm, jp, pm, pp = pair
    frames, toks = _inputs(cfg, 2, 11, 1)     # the gradient test's shapes: one compile
    _close(encdec.encode(pp, torch.from_numpy(frames), cfg), jm.encode(jp, jnp.asarray(frames)))
    batch = {"frames": frames, "tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((2, 10), np.float32)}
    batch["mask"][0, :4] = 0.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    (jl, _), (pl, _) = jm.forward(jp, jb), pm.forward(pp, tb)
    _close(pl, jl)
    (jloss, jmet), _ = jm.grads(jp, jb)
    ploss, pmet = pm.loss(pp, tb)
    _close(ploss, jloss)
    assert set(pmet) == set(jmet) == {"ce", "aux"}


def test_prefill_and_three_decode_steps_match_jax(pair):
    """Prefill logits, the self KV, ``cross_k``/``cross_v`` and ``pos``, then
    three decode steps (each step's logits and every cache leaf)."""
    cfg, jm, jp, pm, pp = pair
    frames, toks = _inputs(cfg, 3, 9, 2)
    cap = 9 + 6
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}, cap)
    pl, pc = pm.prefill(pp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks).long()}, cap)
    _close(pl, jl)
    _assert_caches(pc, jc)
    assert pc["cross_k"].shape == (cfg.num_layers, 3, cfg.enc_frames, cfg.num_kv_heads,
                                   cfg.resolved_head_dim)
    rng = np.random.default_rng(3)
    for _ in range(3):
        nxt = rng.integers(5, cfg.vocab_size, (3,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl, jl)
        _assert_caches(pc, jc)
    assert pc["pos"] == 12


def test_generator_greedy_tokens_match_jax(pair):
    cfg, jm, jp, pm, pp = pair
    frames, toks = _inputs(cfg, 3, 7, 4)
    sampler = dict(vocab_size=cfg.vocab_size)
    jg = JaxGenerator(jm.model, jp, JaxGenerateConfig(max_new_tokens=8,
                                                sampler=JaxSamplerConfig(**sampler)))
    jt, jn, _ = jg.generate_with_lengths({"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)})
    for fused in (True, False):
        pg = Generator(pm, pp, GenerateConfig(max_new_tokens=8, fused=fused,
                                              sampler=SamplerConfig(**sampler)))
        pt, pn, _ = pg.generate_with_lengths({"tokens": toks, "frames": frames})
        assert np.array_equal(np.asarray(pt), np.asarray(jt))
        assert np.array_equal(np.asarray(pn), np.asarray(jn))


def test_train_step_gradients_match_jax(pair):
    """One train step's loss and gradients, every leaf (the cross
    attention's K/V weights through the flash wrapper's backward)."""
    cfg, jm, jp, pm, pp = pair
    frames, toks = _inputs(cfg, 2, 11, 5)
    batch = {"frames": frames, "tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((2, 10), np.float32)}
    (jloss, _), jgrads = jm.grads(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads = value_and_grad(pm, pp, tb)
    _close(loss, jloss)
    want = jax_params_to_torch(_flatten(jgrads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree_leaves(pp))
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale)


def test_remat_gives_the_same_gradients():
    cfg = CFGS["whisper-smoke"]
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(6), "cpu")
    frames, toks = _inputs(cfg, 2, 9, 7)
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks[:, :-1]).long(),
          "targets": torch.from_numpy(toks[:, 1:]).long(), "mask": torch.ones(2, 8)}
    l0, _, g0 = value_and_grad(pm, pp, tb)
    l1, _, g1 = value_and_grad(build_model(cfg.replace(remat=True)), pp, tb)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,length,rows", [(16, 524_296, (0, 1, 524_289, 524_295)),
                                           (384, 2048, (0, 7, 1500, 2047))])
def test_sinusoidal_rows_match_the_reference_table(d, length, rows):
    """The rows the port builds per position equal the reference's whole
    table's, up to whisper's last position (524,295) at a narrow width and
    over the first 2,048 rows at whisper's 384."""
    table = np.asarray(jax_sinusoidal_positions(length, d))
    pos = torch.tensor(rows)
    got = sinusoidal_positions(pos, d)
    assert got.dtype == torch.float32 and got.shape == (len(rows), d)
    np.testing.assert_allclose(got.numpy(), table[list(rows)], rtol=0, atol=1e-6)
    full = sinusoidal_positions(torch.arange(min(length, 2048)), d)
    np.testing.assert_allclose(full.numpy(), table[:2048], rtol=0, atol=1e-6)


def test_decode_step_at_whisper_positions_adds_that_row():
    """Past ``max_seq_len`` the reference's ``dynamic_slice`` clamps to the
    last row; the port does too, and builds no table."""
    cfg = CFGS["whisper-smoke"].replace(max_seq_len=524_296)
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(8), "cpu")
    frames, toks = _inputs(cfg, 2, 4, 9)
    _, caches = pm.prefill(pp, {"frames": torch.from_numpy(frames),
                                "tokens": torch.from_numpy(toks).long()}, 8)
    tok = torch.tensor([5, 6])
    outs = []
    for pos in (524_295, 524_299):
        c = dict(caches, self={k: t.clone() for k, t in caches["self"].items()}, pos=pos)
        outs.append(pm.decode_step(pp, tok, c)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_capability_flags_are_the_references(name):
    cfg = CFGS[name]
    jm, pm = jax_build_model(_jax_cfg(cfg)), build_model(cfg)
    assert pm.is_encdec and jm.is_encdec
    for flag in ("supports_prefix_prefill", "supports_paged_decode", "supports_spec_decode"):
        assert getattr(pm, flag) is getattr(jm, flag) is False
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    assert "frontend_proj" not in pp
    with pytest.raises(ValueError):
        Generator(pm, pp, GenerateConfig(max_new_tokens=4, spec_k=2))
    frames, toks = _inputs(cfg, 1, 4, 0)
    with pytest.raises(NotImplementedError):
        Generator(pm, pp, GenerateConfig(max_new_tokens=4, paged=True)).generate_with_lengths(
            {"tokens": toks, "frames": frames})
    with pytest.raises(NotImplementedError):
        pm.decode_block(pp, torch.zeros((1, 2), dtype=torch.long), None)


def test_checkpoint_round_trip_into_jax_load_checkpoint(tmp_path):
    """Port params -> the reference's ``enc_scan``/``dec_scan`` layout ->
    JAX ``load_checkpoint``: every leaf exact, the JAX forward equal to the
    port's, and back through the converter unchanged."""
    cfg = CFGS["whisper-smoke"]
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(10))
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(11), "cpu")
    for layer in pp["enc_layers"] + pp["dec_layers"]:
        for attn in ("attn", "self_attn", "cross_attn"):
            if attn in layer:
                layer[attn]["b_qkv"].normal_(generator=torch.Generator().manual_seed(12))
    flat = torch_params_to_jax(pp, cfg)
    assert set(flat) == set(_flatten(jp))
    save_checkpoint(str(tmp_path), 1, flat, {"arch": cfg.name},
                    dtypes=torch_param_dtypes(pp, cfg))
    restored, _ = load_checkpoint(str(tmp_path), 1, jp)
    back = jax_params_to_torch(_flatten(restored), cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pp)):
        assert torch.equal(a, b)
    frames, toks = _inputs(cfg, 2, 10, 13)
    want, _ = jax.jit(jm.forward)(restored, {"frames": jnp.asarray(frames),
                                             "tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_train_cli_runs_whisper_on_cpu(capsys):
    """``--arch whisper-tiny``: the reference's note line, then the loss
    falling over random frames."""
    rc = train_cli.main(["--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64",
                         "--arch", "whisper-tiny"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert rc == 0 and "(improved)" in out, out
    assert lines[0].startswith("note: whisper-tiny takes stub multimodal inputs")
    assert lines[1].startswith("arch=whisper-tiny ")
