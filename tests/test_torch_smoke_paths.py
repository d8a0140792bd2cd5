"""Every paged- and speculation-eligible smoke config on every decode path
of the port, against the JAX package on the CPU: the reference's Generator
and the port's on the same weights (JAX init, converted) give the same
greedy tokens and lengths, and in the port the dense, paged, speculative
(K 4) and paged speculative Generators and a paged ``DecodeSession``
(plain and K 4) give the same tokens.  A MoE block's rows depend on their
dispatch group, as the reference's do, so for a MoE config a verify block
(B x K tokens) or a session's step (all its slots) is held to the
reference's same path instead.  These are the configurations whose fp32
decode runs the verify and paged kernels at head dims 16, 24 and 32 on the
card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs import get_config as jax_get_config
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import GenerateConfig as JaxGenerateConfig
from repro.serving import Generator as JaxGenerator
from repro.serving import DecodeSession as JaxDecodeSession
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serving.continuous import DecodeSession, leaked_pages
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

# (id, head dim, G) of the smoke configs the paged and speculative paths take
PAGED_SMOKE = [("qwen2.5-3b", 32, 2), ("deepseek-coder-33b", 16, 4), ("arctic-480b", 16, 4),
               ("qwen3-moe-235b-a22b", 16, 4), ("internvl2-26b", 16, 4),
               ("nemotron-4-340b", 24, 4)]
B, S, MNT, K, PAGE = 3, 10, 8, 4, 4


def test_the_paged_smoke_configs_are_the_eligible_ones():
    """The list above is every assigned id whose smoke config's flags allow
    paged and speculative decode, in the port and in the reference alike."""
    eligible = []
    for arch in ASSIGNED_ARCHS:
        m = build_model(get_config(arch, smoke=True))
        jm = jax_build_model(jax_get_config(arch, smoke=True))
        assert ((m.supports_paged_decode, m.supports_spec_decode)
                == (jm.supports_paged_decode, jm.supports_spec_decode))
        if m.supports_paged_decode and m.supports_spec_decode:
            eligible.append(arch)
    assert sorted(eligible) == sorted(a for a, _, _ in PAGED_SMOKE)


@pytest.mark.parametrize("arch,dh,g", PAGED_SMOKE)
def test_smoke_config_tokens_equal_jax_on_every_path(arch, dh, g):
    cfg = get_config(arch, smoke=True)
    assert (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads, cfg.dtype) == (
        dh, g, "float32")
    jcfg = jax_get_config(arch, smoke=True)
    assert jcfg == JaxModelConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)})
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    pm, pp = build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(5, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = ({"prefix_embeds": rng.standard_normal(
        (B, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)}
        if cfg.num_prefix_tokens else {})
    sampler = dict(vocab_size=cfg.vocab_size)
    jbase = JaxGenerateConfig(max_new_tokens=MNT, sampler=JaxSamplerConfig(**sampler))
    jbatch = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    jg = JaxGenerator(jm, jp, jbase)
    jt, jn, _ = (np.asarray(x) for x in jg.generate_with_lengths(jbatch))
    drafts = jt.copy()
    drafts[1, MNT // 2:] = (drafts[1, MNT // 2:] + 1 - 5) % (cfg.vocab_size - 5) + 5
    drafts = (drafts, np.full(B, MNT, np.int32))
    # a session takes token prompts alone, as the reference's does
    plain = (np.asarray(jg.generate_with_lengths({"tokens": jnp.asarray(toks)})[0])
             if extra else jt)
    want = {"dense": (jt, jn), "paged": (jt, jn), "spec": (jt, jn), "paged_spec": (jt, jn),
            "session_1": plain, f"session_{K}": plain}
    if cfg.num_experts:        # other dispatch groups: the reference's same path
        jspec = JaxGenerator(jm, jp, dataclasses.replace(jbase, spec_k=K))
        spec_out = tuple(np.asarray(x) for x in jspec.generate_with_lengths(jbatch,
                                                                            drafts=drafts))
        want["spec"] = want["paged_spec"] = spec_out[:2]
        for spec_k in (1, K):
            sess = JaxDecodeSession(JaxGenerator(jm, jp, dataclasses.replace(
                jbase, paged=True, page_size=PAGE)), slots=4, capacity=S + MNT + 1, seed=0,
                spec_k=spec_k)
            sess.admit(toks, tags=list(range(B)),
                       drafts=(plain, np.full(B, MNT, np.int32)) if spec_k > 1 else None)
            done = sorted(sess.drain(chunk=K if spec_k > 1 else 0), key=lambda f: f["tag"])
            want[f"session_{spec_k}"] = np.stack([f["tokens"] for f in done])
    base = GenerateConfig(max_new_tokens=MNT, sampler=SamplerConfig(**sampler))
    batch = {"tokens": toks, **extra}
    with torch.no_grad():
        for name, changes, d in (("dense", {}, None),
                                 ("paged", dict(paged=True, page_size=PAGE), None),
                                 ("spec", dict(spec_k=K), drafts),
                                 ("paged_spec", dict(paged=True, page_size=PAGE, spec_k=K),
                                  drafts)):
            gen = Generator(pm, pp, dataclasses.replace(base, **changes))
            pt, pn, _ = gen.generate_with_lengths(batch, drafts=d)
            assert np.array_equal(pt, want[name][0]), name
            assert np.array_equal(pn, want[name][1]), name
            if d is not None:
                assert gen.last_spec_stats["accepted"] > 0, name
            if gen.pool is not None:
                assert gen.pool.live_pages == 0, name
        for spec_k in (1, K):
            sess = DecodeSession(Generator(pm, pp, dataclasses.replace(
                base, paged=True, page_size=PAGE)), slots=4, capacity=S + MNT + 1, seed=0,
                spec_k=spec_k)
            sess.admit(toks, tags=list(range(B)),
                       drafts=(plain, np.full(B, MNT, np.int32)) if spec_k > 1 else None)
            done = sorted(sess.drain(chunk=K if spec_k > 1 else 0), key=lambda f: f["tag"])
            got = np.stack([f["tokens"] for f in done])
            assert np.array_equal(got, want[f"session_{spec_k}"]), spec_k
            assert leaked_pages(sess) + sess.pool.live_pages == 0
