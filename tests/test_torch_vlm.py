"""The prefix-embedding frontend of the port (internvl2's vision stub:
``frontend_proj`` and ``prefix_embeds`` in ``models/transformer.py``)
against the JAX package's on the CPU, fp32: internvl2-26b's SMOKE config
(8 prefix tokens, G 4) and the VLM of the reference's system test (4
prefix tokens, G 2).

Same weights (JAX init converted by ``checkpoint.jax_params_to_torch``),
same numpy prefix embeddings and tokens: the forward logits, the loss,
prefill (logits and every KV leaf), three decode steps, greedy
``Generator`` tokens (dense against JAX, paged and speculative against
dense), one train step's gradients, ``frontend_proj``'s zero gradient in a
loss without ``prefix_embeds``, the refusal of ``prefix`` with
``prefix_embeds``, the capability flags, the checkpoint round trip and the
train CLI.

Tolerance rtol/atol 1e-5; gradients within 1e-4 of each leaf's largest |g|.
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
from repro.models import transformer as jax_transformer
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro_torch import configs
from repro_torch.checkpoint import (jax_params_to_torch, save_checkpoint, torch_param_dtypes,
                                    torch_params_to_jax)
from repro_torch.launch import train as train_cli
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import transformer
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import value_and_grad
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)
# the VLM of tests/test_system.py::test_decode_matches_forward_vlm
SYSTEM = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                     vocab_size=256, frontend="vision_stub", num_prefix_tokens=4,
                     frontend_dim=32, dtype="float32")
CFGS = {"internvl2-smoke": configs.get_config("internvl2-26b", smoke=True), "system": SYSTEM}


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


class _Jitted:
    """The JAX model's entry points under ``jax.jit``."""

    def __init__(self, jm):
        self.model = jm
        self.forward = jax.jit(jm.forward)
        self.prefill = jax.jit(jm.prefill, static_argnums=2)
        self.decode_step = jax.jit(jm.decode_step)
        self.grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    """(cfg, jitted jax model, jax params, port model, port params)."""
    cfg = CFGS[request.param]
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, _Jitted(jm), jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg,
                                                                      device="cpu")


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    pe = rng.standard_normal((b, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(5, cfg.vocab_size, (b, s)).astype(np.int32)
    return pe, toks


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


def _assert_caches(port, ref):
    for leaf in ("k", "v", "slot_pos"):
        _close(port["scan"][0][leaf], ref["scan"][0][leaf], err_msg=leaf)
    assert port["pos"] == int(ref["pos"])


def _batch(pe, toks, mask=True):
    batch = {"prefix_embeds": pe, "tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["mask"] = np.ones(toks[:, 1:].shape, np.float32)
    return batch


def _torch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ("tokens", "targets"):
        if k in out:
            out[k] = out[k].long()
    return out


def test_forward_and_loss_match_jax(pair):
    """The projected prefix in front of the tokens: logits at P+S positions;
    the loss over the token positions only."""
    cfg, jm, jp, pm, pp = pair
    pe, toks = _inputs(cfg, 2, 11, 1)     # the gradient test's shapes: one compile
    batch = _batch(pe, toks)
    batch["mask"][0, :4] = 0.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), (pl, _) = jm.forward(jp, jb), pm.forward(pp, _torch(batch))
    assert pl.shape[1] == cfg.num_prefix_tokens + 10
    _close(pl, jl)
    (jloss, _), _ = jm.grads(jp, jb)
    ploss, pmet = pm.loss(pp, _torch(batch))
    _close(ploss, jloss)
    assert int(pmet["tokens"]) == 2 * 10 - 4


def test_prefill_and_three_decode_steps_match_jax(pair):
    cfg, jm, jp, pm, pp = pair
    pe, toks = _inputs(cfg, 3, 9, 2)
    cap = cfg.num_prefix_tokens + 9 + 6
    jl, jc = jm.prefill(jp, {"prefix_embeds": jnp.asarray(pe), "tokens": jnp.asarray(toks)},
                        cap)
    pl, pc = pm.prefill(pp, {"prefix_embeds": torch.from_numpy(pe),
                             "tokens": torch.from_numpy(toks).long()}, cap)
    _close(pl, jl)
    _assert_caches(pc, jc)
    assert pc["pos"] == cfg.num_prefix_tokens + 9
    rng = np.random.default_rng(3)
    for _ in range(3):
        nxt = rng.integers(5, cfg.vocab_size, (3,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl, jl)
        _assert_caches(pc, jc)


def test_generator_tokens_match_jax_dense_paged_and_speculative(pair):
    """Greedy tokens: the fused and host loops equal the reference's
    Generator; the paged Generator (its capacity counting the prefix) and
    the speculative one (K 4, drafts the reference's tokens with one token of
    row 1 changed) equal the dense ones, with no page left."""
    cfg, jm, jp, pm, pp = pair
    pe, toks = _inputs(cfg, 3, 7, 4)
    mnt = 10
    sampler = dict(vocab_size=cfg.vocab_size)
    jg = JaxGenerator(jm.model, jp, JaxGenerateConfig(max_new_tokens=mnt,
                                                      sampler=JaxSamplerConfig(**sampler)))
    jt, jn, _ = jg.generate_with_lengths({"tokens": jnp.asarray(toks),
                                          "prefix_embeds": jnp.asarray(pe)})
    base = GenerateConfig(max_new_tokens=mnt, sampler=SamplerConfig(**sampler))
    batch = {"tokens": toks, "prefix_embeds": pe}
    for fused in (True, False):
        pt, pn, _ = Generator(pm, pp, dataclasses.replace(base, fused=fused)) \
            .generate_with_lengths(batch)
        assert np.array_equal(pt, np.asarray(jt)) and np.array_equal(pn, np.asarray(jn))
    paged = Generator(pm, pp, dataclasses.replace(base, paged=True, page_size=4))
    pt, pn, _ = paged.generate_with_lengths(batch)
    assert np.array_equal(pt, np.asarray(jt)) and np.array_equal(pn, np.asarray(jn))
    assert paged.pool.live_pages == 0
    drafts = np.asarray(jt).copy()
    drafts[1, 3] = (drafts[1, 3] + 1) % cfg.vocab_size
    spec = Generator(pm, pp, dataclasses.replace(base, spec_k=4))
    pt, pn, _ = spec.generate_with_lengths(batch, drafts=(drafts, np.full(3, mnt, np.int32)))
    assert np.array_equal(pt, np.asarray(jt)) and np.array_equal(pn, np.asarray(jn))
    assert spec.last_spec_stats["accepted"] > 0


def test_train_step_gradients_match_jax(pair):
    cfg, jm, jp, pm, pp = pair
    pe, toks = _inputs(cfg, 2, 11, 5)
    batch = _batch(pe, toks)
    (jloss, _), jgrads = jm.grads(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = value_and_grad(pm, pp, _torch(batch))
    _close(loss, jloss)
    want = jax_params_to_torch(_flatten(jgrads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree_leaves(pp))
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale)


def test_loss_without_prefix_embeds_gives_frontend_proj_a_zero_gradient(pair):
    """The reference's loss of tokens alone leaves ``frontend_proj`` unused,
    and JAX gives it a zero gradient; so does the port, for that leaf only:
    any other parameter that does not reach the loss still raises."""
    cfg, jm, jp, pm, pp = pair
    _, toks = _inputs(cfg, 2, 11, 6)
    batch = _batch(None, toks)
    del batch["prefix_embeds"]
    (jloss, _), jgrads = jm.grads(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = value_and_grad(pm, pp, _torch(batch))
    _close(loss, jloss)
    assert not np.asarray(jgrads["frontend_proj"]).any()
    assert grads["frontend_proj"].shape == pp["frontend_proj"].shape
    assert not grads["frontend_proj"].any()
    assert float(grads["embed"].abs().max()) > 0
    extra = dict(pp, stray=torch.zeros(3))
    with pytest.raises(RuntimeError, match="got no gradient"):
        value_and_grad(pm, extra, _torch(batch))


def test_prefill_refuses_a_stored_prefix_with_prefix_embeds():
    cfg = CFGS["system"]
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    pe, toks = _inputs(cfg, 2, 6, 7)
    _, stored = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, 6)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        transformer.prefill(pp, torch.from_numpy(toks).long(), cfg, 20, prefix=stored,
                            prefix_embeds=torch.from_numpy(pe))
    jp = jax_build_model(_jax_cfg(cfg)).init(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="prefix_embeds"):   # the reference too
        jax_transformer.prefill(jp, jnp.asarray(toks), _jax_cfg(cfg), 20, prefix={"pos": 6},
                                prefix_embeds=jnp.asarray(pe))
    with pytest.raises(NotImplementedError):
        pm.prefill_prefix(pp, torch.from_numpy(toks).long())


@pytest.mark.parametrize("name", sorted(CFGS) + ["internvl2-26b"])
def test_capability_flags_are_the_references(name):
    cfg = CFGS.get(name) or configs.get_config(name)
    jm, pm = jax_build_model(_jax_cfg(cfg)), build_model(cfg)
    assert not pm.is_encdec and not jm.is_encdec
    assert pm.supports_prefix_prefill is jm.supports_prefix_prefill is False
    assert pm.supports_paged_decode is jm.supports_paged_decode is True
    assert pm.supports_spec_decode is jm.supports_spec_decode is True


def test_checkpoint_round_trip_into_jax_load_checkpoint(tmp_path):
    """``frontend_proj`` and the stack to the reference's layout, through
    JAX ``load_checkpoint`` and back, exact; the forwards agree."""
    cfg = CFGS["internvl2-smoke"]
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(10))
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(11), "cpu")
    assert pp["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    flat = torch_params_to_jax(pp, cfg)
    assert set(flat) == set(_flatten(jp))
    save_checkpoint(str(tmp_path), 1, flat, {"arch": cfg.name},
                    dtypes=torch_param_dtypes(pp, cfg))
    restored, _ = load_checkpoint(str(tmp_path), 1, jp)
    back = jax_params_to_torch(_flatten(restored), cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pp)):
        assert torch.equal(a, b)
    pe, toks = _inputs(cfg, 2, 10, 13)
    want, _ = jax.jit(jm.forward)(restored, {"prefix_embeds": jnp.asarray(pe),
                                             "tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"prefix_embeds": torch.from_numpy(pe),
                             "tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_train_cli_runs_internvl2_on_cpu(capsys):
    """``--arch internvl2-26b``: the note line, then the loss falling over
    random prefix embeddings."""
    rc = train_cli.main(["--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64",
                         "--arch", "internvl2-26b"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert rc == 0 and "(improved)" in out, out
    assert lines[0].startswith("note: internvl2-26b takes stub multimodal inputs")
    assert lines[1].startswith("arch=internvl2-26b ")
