"""Port generation: greedy tokens, lengths and ended flags equal to the JAX
package's for the same weights (with and without a prefix cache), and the
port's fused decode equal to its host-loop oracle."""
import dataclasses
import types

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
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.launch.serve import model_configs
from repro_torch.models import ModelConfig as PortModelConfig
from repro_torch.models import build_model
from repro_torch.serving.continuous import DecodeSession
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig, greedy_ids, mask_vocab
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

VOCAB, EOS = 512, 2


def _generators(which: str, mnt=8, temperature=0.0):
    big, small, _, _ = model_configs("serve-tiny", vocab=VOCAB)
    cfg = small if which == "small" else big
    jm = jax_build_model(JaxModelConfig(**cfg.__dict__))
    jp = jm.init(jax.random.PRNGKey(7))
    jg = JaxGenerator(jm, jp, JaxGenerateConfig(
        max_new_tokens=mnt, eos_id=EOS,
        sampler=JaxSamplerConfig(temperature=temperature, vocab_size=VOCAB)))
    pg = Generator(build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu"),
                   GenerateConfig(max_new_tokens=mnt, eos_id=EOS,
                                  sampler=SamplerConfig(temperature=temperature,
                                                        vocab_size=VOCAB)))
    return jg, pg


@pytest.mark.parametrize("which", ["big", "small"])
def test_greedy_generate_matches_jax(which):
    jg, pg = _generators(which)
    toks = np.random.default_rng(0).integers(5, VOCAB, (4, 16)).astype(np.int32)
    j = jg.generate_with_lengths({"tokens": jnp.asarray(toks)}, seed=3)
    p = pg.generate_with_lengths({"tokens": toks}, seed=3)
    for a, b in zip(p, j):
        assert np.array_equal(a, np.asarray(b))
    p_host = pg.generate_with_lengths({"tokens": toks}, seed=3, fused=False)
    for a, b in zip(p_host, p):
        assert np.array_equal(a, b)


def test_prefix_cache_generate_matches_jax_and_full():
    jg, pg = _generators("small")
    rng = np.random.default_rng(1)
    prefix = rng.integers(5, VOCAB, 45).tolist()
    suf = rng.integers(5, VOCAB, (2, 16)).astype(np.int32)
    j = jg.generate_with_lengths({"tokens": jnp.asarray(suf)}, seed=0,
                                 prefix_cache=jg.build_prefix_cache(prefix, 2))
    pc = pg.build_prefix_cache(prefix, 2)
    p = pg.generate_with_lengths({"tokens": suf}, seed=0, prefix_cache=pc)
    full = np.concatenate([np.broadcast_to(np.asarray(prefix, np.int32), (2, 45)), suf], 1)
    p_full = pg.generate_with_lengths({"tokens": full}, seed=0)
    for a, b, c in zip(p, j, p_full):
        assert np.array_equal(a, np.asarray(b))
        assert np.array_equal(a, c)
    with pytest.raises(ValueError):
        pg.generate_with_lengths({"tokens": suf[:1]}, prefix_cache=pc)


class _Script:
    """Stub model: step t emits logits peaked on script[:, t]."""

    supports_prefix_prefill = False

    def __init__(self, script):
        self.script = torch.as_tensor(script)
        self.cfg = types.SimpleNamespace(max_seq_len=256, num_prefix_tokens=0)

    def _logits(self, step):
        idx = min(step, self.script.shape[1] - 1)
        return torch.nn.functional.one_hot(self.script[:, idx].long(), VOCAB).float() * 100

    def prefill(self, params, batch, capacity):
        return self._logits(0), {"step": 0}

    def decode_step(self, params, token, caches):
        return self._logits(caches["step"] + 1), {"step": caches["step"] + 1}


@pytest.mark.parametrize("fused", [True, False])
def test_lengths_and_ended_from_early_eos(fused):
    script = np.array([[5, 7, EOS, 9, 9, 9],      # ends at step 2
                       [EOS, 5, 5, 5, 5, 5],      # ends at once
                       [6, 6, 6, 6, 6, 6],        # never ends
                       [6, 6, 6, 6, 6, EOS]])     # ends on the last step
    g = Generator(_Script(script), {"embed": torch.zeros(1)},
                  GenerateConfig(max_new_tokens=6, eos_id=EOS))
    toks, lengths, ended = g.generate_with_lengths({"tokens": np.zeros((4, 3), np.int32)},
                                                   fused=fused)
    assert lengths.tolist() == [3, 1, 6, 6]
    assert ended.tolist() == [True, True, False, True]
    assert toks[0].tolist() == [5, 7, EOS, EOS, EOS, EOS]
    assert toks[1].tolist() == [EOS] * 6


def test_fused_equals_host_loop_under_sampling():
    _, pg = _generators("big", mnt=10, temperature=0.9)
    toks = np.random.default_rng(2).integers(5, VOCAB, (3, 16)).astype(np.int32)
    a = pg.generate_with_lengths({"tokens": toks}, seed=11)
    b = pg.generate_with_lengths({"tokens": toks}, seed=11, fused=False)
    c = pg.generate_with_lengths({"tokens": toks}, seed=12)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].max() < VOCAB


def test_greedy_ties_go_to_lowest_id_and_vocab_mask():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert greedy_ids(logits).tolist() == [1, 0]
    masked = mask_vocab(torch.tensor([[0.0, 1.0, 9.0]]), SamplerConfig(vocab_size=2))
    assert greedy_ids(masked).tolist() == [1]


def test_zero_budget_and_off_slice_options():
    _, pg = _generators("big")
    t, n, e = pg.generate_with_lengths({"tokens": np.zeros((2, 4), np.int32)},
                                       max_new_tokens=0)
    assert t.shape == (2, 0) and n.tolist() == [0, 0] and e.tolist() == [False, False]
    # the JAX package's speculation checks, now that drafts are ported
    with pytest.raises(ValueError, match="spec_k"):
        GenerateConfig(spec_k=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        GenerateConfig(max_new_tokens=4, spec_k=8)
    with pytest.raises(ValueError, match="greedy"):
        GenerateConfig(spec_k=2, sampler=SamplerConfig(temperature=0.5))
    # a spec session, once refused, decodes the plain tokens from its drafts
    gen = Generator(pg.model, pg.params, GenerateConfig(max_new_tokens=8))
    prompts = np.full((2, 4), 7, np.int32)
    plain = gen.generate_with_lengths({"tokens": prompts})
    sess = DecodeSession(gen, slots=2, capacity=32, spec_k=2)
    sess.admit(prompts, drafts=(plain[0], plain[1]))
    fins = sorted(sess.drain(), key=lambda f: f["slot"])
    assert np.array_equal(np.stack([f["tokens"] for f in fins]), plain[0])
    assert sess.spec_stats["accepted"] > 0
    # an encoder-decoder builds and neither pages nor speculates; a frontend
    # stack pages and speculates but has no prefix path: the reference's flags
    for cfg in (PortModelConfig(enc_layers=2),
                PortModelConfig(frontend="vision_stub", num_prefix_tokens=4, frontend_dim=8)):
        got, want = build_model(cfg), jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
        assert got.is_encdec == want.is_encdec == bool(cfg.enc_layers)
        for flag in ("supports_prefix_prefill", "supports_paged_decode", "supports_spec_decode"):
            on = not cfg.enc_layers and flag != "supports_prefix_prefill"
            assert getattr(got, flag) is getattr(want, flag) is on
    windowed = build_model(PortModelConfig(sliding_window=16))
    assert not windowed.supports_paged_decode and not windowed.supports_spec_decode
    assert not windowed.supports_prefix_prefill
