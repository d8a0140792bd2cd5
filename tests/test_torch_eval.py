"""The port's referee judge and debate protocol against the JAX package's.

The log-likelihood scorer runs the same converted weights on the same texts
(fp32, tolerance 1e-4: CPU rounding of two frameworks); the features,
persona scores and the debate are host code and must agree exactly, draws
of the seeded numpy RNG included.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import eval as jax_eval
from repro.checkpoint.checkpoint import _flatten
from repro.data import QuestionPairGenerator as JaxPairs
from repro.data import synthesize_response as jax_synth
from repro.eval import judge as jax_judge
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro_torch import eval as port_eval
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.data import QuestionPairGenerator, synthesize_response
from repro_torch.eval import judge
from repro_torch.models import ModelConfig, build_model
from repro_torch.tokenizer import HashWordTokenizer

VOCAB = 512


def _texts(n, seed=0):
    """(queries, big responses, small responses) of ``n`` duplicate pairs."""
    gen = QuestionPairGenerator(seed=seed)
    queries, big, small = [], [], []
    for _ in range(n):
        _, b = gen.duplicate_pair()
        queries.append(b.text)
        big.append(synthesize_response(b.text, b.topic, b.intent, quality="big"))
        small.append(synthesize_response(b.text, b.topic, b.intent, quality="small"))
    return queries, big, small


def _scorers(impl, max_len, seed=0):
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=VOCAB, dtype="float32", attention_impl=impl,
                      flash_block_q=32, flash_block_k=32)
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    pp = jax_params_to_torch(_flatten(jp), cfg, device="cpu")
    return (jax_judge.make_loglik_scorer(jm, jp, JaxTokenizer(VOCAB), max_len=max_len),
            judge.make_loglik_scorer(build_model(cfg), pp, HashWordTokenizer(VOCAB),
                                     max_len=max_len))


def test_the_text_generators_are_the_reference():
    queries, big, small = _texts(6, seed=4)
    gen = JaxPairs(seed=4)
    for q, b, s in zip(queries, big, small):
        _, jb = gen.duplicate_pair()
        assert q == jb.text
        assert b == jax_synth(jb.text, jb.topic, jb.intent, quality="big")
        assert s == jax_synth(jb.text, jb.topic, jb.intent, quality="small")


@pytest.mark.parametrize("impl,max_len", [("naive", 48), ("xla_flash", 64), ("naive", 192)])
def test_loglik_scorer_matches_jax(impl, max_len):
    want_fn, got_fn = _scorers(impl, max_len)
    queries, big, small = _texts(10)
    for responses in (big, small):
        want, got = want_fn(queries, responses), got_fn(queries, responses)
        assert got.shape == (10,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_scorer_chunks_score_as_one_batch(monkeypatch):
    """A batch split into chunks of rows scores as the whole batch does."""
    queries, big, _ = _texts(7, seed=1)
    whole = _scorers("naive", 64)[1](queries, big)
    monkeypatch.setattr(judge, "LOGIT_BYTES", 64 * VOCAB * 4 * 3)     # 3 rows a chunk
    chunked = _scorers("naive", 64)[1](queries, big)
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6)


def test_scorer_runs_without_grad():
    _, score = _scorers("naive", 48)
    with torch.enable_grad():
        out = score(["what is keto"], ["keto is a diet plan"])
    assert out.shape == (1,) and np.isfinite(out[0])


def test_features_and_persona_scores_are_the_reference():
    queries, big, small = _texts(25, seed=2)
    for q, responses in zip(queries, zip(big, small)):
        for r in responses + ("", "it depends", " ".join(["word"] * 300)):
            assert judge.relevance_overlap(q, r) == jax_judge.relevance_overlap(q, r)
            assert judge.structure_score(r) == jax_judge.structure_score(r)
            assert judge.length_appropriateness(r) == jax_judge.length_appropriateness(r)
            for p, jp in zip(port_eval.PERSONAS, jax_eval.PERSONAS):
                assert dataclasses.asdict(p) == dataclasses.asdict(jp)
                assert (port_eval.persona_score(p, -2.5, q, r)
                        == jax_eval.persona_score(jp, -2.5, q, r))
    assert judge.relevance_overlap("", "anything") == 0.0


def _debate_inputs(n=50, seed=5):
    queries, big, small = _texts(n, seed=seed)
    rng = np.random.default_rng(seed)
    la = list(-3.0 * rng.random(n))
    lb = list(-3.0 * rng.random(n))
    lb[:5] = la[:5]                      # equal logliks: ties decided by the features
    return queries, big, small, la, lb


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.verdict == w.verdict and g.votes == w.votes and g.margins == w.margins


def test_run_debate_is_the_reference():
    queries, big, small, la, lb = _debate_inputs()
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    got = [port_eval.run_debate(q, a, b, x, y, rng=r1)
           for q, a, b, x, y in zip(queries, big, small, la, lb)]
    want = [jax_eval.run_debate(q, a, b, x, y, rng=r2)
            for q, a, b, x, y in zip(queries, big, small, la, lb)]
    _same_results(got, want)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)       # the same draws were taken


@pytest.mark.parametrize("seed", [0, 1])
def test_debate_batch_and_shares_are_the_reference(seed):
    queries, big, small, la, lb = _debate_inputs()
    got = port_eval.debate_batch(queries, big, small, la, lb, seed=seed)
    want = jax_eval.debate_batch(queries, big, small, la, lb, seed=seed)
    _same_results(got, want)
    shares = port_eval.verdict_shares(got)
    assert shares == jax_eval.verdict_shares(want)
    assert abs(sum(shares.values()) - 1.0) < 1e-12
    assert {r.verdict for r in got} <= {"A", "B", "AB"}
