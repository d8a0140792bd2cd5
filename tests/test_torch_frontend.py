"""The port's framework-free copies against the JAX package: tokenizer ids,
batch/length buckets, Appendix-A tweak rows and suffix batches, and the
synthetic traffic generators, all byte-equal."""
import numpy as np
import pytest

from repro.core import tweak as jax_tweak
from repro.data import questions as jax_questions
from repro.serving import batcher as jax_batcher
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro_torch.core import tweak as port_tweak
from repro_torch.data import questions as port_questions
from repro_torch.serving import batcher as port_batcher
from repro_torch.tokenizer import HashWordTokenizer as PortTokenizer

TEXTS = ["how do i learn python setup", "What's the PRICE of solar panels?!",
         "", "why is keto diet good answer briefly", "a b c " * 30]


@pytest.mark.parametrize("vocab", [512, 8192, 128256])
def test_tokenizer_ids_equal(vocab):
    jt, pt = JaxTokenizer(vocab), PortTokenizer(vocab)
    for text in TEXTS:
        assert pt.encode(text) == jt.encode(text)
        assert pt.encode(text, add_bos=False, add_eos=True) == jt.encode(
            text, add_bos=False, add_eos=True)
    for a, b in zip(pt.encode_batch(TEXTS, 16), jt.encode_batch(TEXTS, 16)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ids = jt.encode(TEXTS[1]) + [2, 3]
    assert pt.decode_ids(ids) == jt.decode_ids(ids)


def test_buckets_equal():
    for n in range(0, 2200, 7):
        assert port_batcher.bucket_len(n) == jax_batcher.bucket_len(n)
        assert port_batcher.floor_len_bucket(n) == jax_batcher.floor_len_bucket(n)
    for n in range(1, 200):
        assert port_batcher.bucket_batch(n) == jax_batcher.bucket_batch(n)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 99, (5, 21)).astype(np.int32)
    mask = (rng.random((5, 21)) < 0.8).astype(np.float32)
    for a, b in zip(port_batcher.pad_to_buckets(toks, mask),
                    jax_batcher.pad_to_buckets(toks, mask)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("max_len", [200, 90, 64])
def test_tweak_rows_equal(max_len):
    tok = PortTokenizer(8192)
    jtok = JaxTokenizer(8192)
    new = ["why should i try yoga answer briefly", "how long does piano take answer briefly"]
    cq = ["why is yoga good answer briefly", "what is the time needed for piano"]
    cr = ["here is a detailed answer " * 6, "short"]
    assert port_tweak.tweak_prefix_ids(tok) == jax_tweak.tweak_prefix_ids(jtok)
    for suffix_only in (False, True):
        assert (port_tweak.static_token_count(tok, suffix_only=suffix_only)
                == jax_tweak.static_token_count(jtok, suffix_only=suffix_only))
    for fn in ("build_tweak_batch", "build_tweak_suffix_batch"):
        a = getattr(port_tweak, fn)(tok, new, cq, cr, max_len)
        b = getattr(jax_tweak, fn)(jtok, new, cq, cr, max_len)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert port_tweak.build_tweak_text(new[0], cq[0], cr[0]) == jax_tweak.build_tweak_text(
        new[0], cq[0], cr[0])
    assert port_tweak.preprocess_query(" hi ") == jax_tweak.preprocess_query(" hi ")


def test_tweak_budget_too_small_raises_like_reference():
    tok = PortTokenizer(8192)
    with pytest.raises(ValueError):
        port_tweak.build_tweak_batch(tok, ["q"], ["c"], ["r"], 10)
    with pytest.raises(ValueError):
        jax_tweak.build_tweak_batch(JaxTokenizer(8192), ["q"], ["c"], ["r"], 10)


@pytest.mark.parametrize("profile", ["lmsys", "wildchat"])
def test_workload_and_pairs_equal(profile):
    pw, jw = (port_questions.WorkloadGenerator(profile, seed=3),
              jax_questions.WorkloadGenerator(profile, seed=3))
    for _ in range(3):
        assert [(q.text, q.topic, q.intent) for q in pw.sample(50)] == [
            (q.text, q.topic, q.intent) for q in jw.sample(50)]
    pp, jp = port_questions.QuestionPairGenerator(5), jax_questions.QuestionPairGenerator(5)
    pa = [(a.text, b.text, y) for a, b, y in pp.generate(40)]
    ja = [(a.text, b.text, y) for a, b, y in jp.generate(40)]
    assert pa == ja
    assert ([q.text for q in pp.triple()] == [q.text for q in jp.triple()])
    assert port_questions.synthesize_response("q", 3, "how") == \
        jax_questions.synthesize_response("q", 3, "how")
