"""The tensor assembly of TWEAK prompts (``core/tweak.py``'s
``encode_static_segments`` and ``build_tweak_batch_tokens``) against the JAX
package's: equal on padded random field tokens, and equal to the text oracle
on unpadded ones (as ``tests/test_system.py`` checks the reference)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tweak as jax_tweak
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro_torch.core import tweak
from repro_torch.tokenizer import HashWordTokenizer
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

VOCAB = 4096


def _fields(rng, b, lens, vocab):
    """(tokens int32, mask float32) per field, each row padded at the end
    from a random length (0 allowed) with id 0."""
    out = []
    for n in lens:
        t = rng.integers(3, vocab, (b, n)).astype(np.int32)
        used = rng.integers(0, n + 1, (b,))
        m = (np.arange(n)[None, :] < used[:, None]).astype(np.float32)
        out += [np.where(m > 0, t, 0).astype(np.int32), m]
    return out


def test_static_segments_equal_the_reference():
    statics = tweak.encode_static_segments(HashWordTokenizer(VOCAB), "cpu")
    want = jax_tweak.encode_static_segments(JaxTokenizer(VOCAB))
    assert len(statics) == len(want) == 4
    for got, w in zip(statics, want):
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert got.tolist() == w.tolist()


@pytest.mark.parametrize("b,lens,seed", [(3, (5, 7, 11), 0), (1, (1, 16, 4), 1),
                                         (8, (12, 40, 9), 2)])
def test_batch_tokens_equal_the_reference_on_padded_fields(b, lens, seed):
    rng = np.random.default_rng(seed)
    nq, nm, cq, cm, cr, crm = _fields(rng, b, lens, VOCAB)
    statics = tweak.encode_static_segments(HashWordTokenizer(VOCAB), "cpu")
    toks, mask = tweak.build_tweak_batch_tokens(
        statics, *(torch.from_numpy(x) for x in (nq, nm, cq, cm, cr, crm)))
    jt, jm = jax_tweak.build_tweak_batch_tokens(
        jax_tweak.encode_static_segments(JaxTokenizer(VOCAB)),
        *(jnp.asarray(x) for x in (nq, nm, cq, cm, cr, crm)))
    assert toks.dtype == torch.int32 and mask.dtype == torch.float32
    assert toks.shape == mask.shape == (b, sum(len(s) for s in statics) + sum(lens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


@pytest.mark.parametrize("q,cq,cr", [
    ("what is rust", "what is go", "a compiled language"),
    ("how do i learn python setup answer briefly", "best way to learn python",
     "install python then read the tutorial and write small programs every day"),
])
def test_batch_tokens_equal_the_text_oracle_unpadded(q, cq, cr):
    tok = HashWordTokenizer(VOCAB)
    oracle = tok.encode(tweak.build_tweak_text(q, cq, cr))
    assert oracle == JaxTokenizer(VOCAB).encode(jax_tweak.build_tweak_text(q, cq, cr))
    enc = lambda t: torch.tensor(tok.encode(t, add_bos=False), dtype=torch.int32)[None]
    ones = lambda t: torch.ones(t.shape, dtype=torch.float32)
    nq_t, cq_t, cr_t = enc(q), enc(cq), enc(cr)
    toks, mask = tweak.build_tweak_batch_tokens(
        tweak.encode_static_segments(tok, "cpu"), nq_t, ones(nq_t), cq_t, ones(cq_t),
        cr_t, ones(cr_t))
    assert toks[0].tolist() == oracle
    assert bool(mask.all())
    # the prefix KV split: the first static segment is the shared prefix
    assert toks[0, :len(tweak.tweak_prefix_ids(tok))].tolist() == tweak.tweak_prefix_ids(tok)


def test_batch_tokens_stay_on_the_fields_device_and_shape():
    """Pure tensor ops: the output has the fields' dtype and device, a fixed
    shape, and rows that differ only in their fields."""
    tok = HashWordTokenizer(VOCAB)
    statics = tweak.encode_static_segments(tok, torch.device("cpu"))
    n_static = sum(len(s) for s in statics)
    nq, cq, cr = (torch.full((2, n), 7, dtype=torch.int32) for n in (4, 3, 6))
    toks, mask = tweak.build_tweak_batch_tokens(
        statics, nq, torch.ones(2, 4), cq, torch.ones(2, 3), cr, torch.ones(2, 6))
    assert toks.shape == (2, n_static + 3 + 6 + 4) and mask.shape == toks.shape
    assert torch.equal(toks[0], toks[1])
