"""The port's cross-encoder reranker against the JAX package's.

``score_pairs`` and ``score_shortlist`` on JAX parameters converted with
``checkpoint.convert`` agree within 1e-5; the port holds the properties
``tests/test_reranker.py`` holds for the reference: scores depend on the
valid tokens only (padding, and what lies under the mask, move nothing,
within 1e-5), and permuting the candidates permutes the scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.models.reranker import init_reranker as jax_init_reranker
from repro.models.reranker import score_pairs as jax_score_pairs
from repro.models.reranker import score_shortlist as jax_score_shortlist
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.launch.serve import model_configs
from repro_torch.models import reranker
from repro_torch.models.embedder import MINILM_CONFIG
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

CFG = reranker.tiny_reranker_config(vocab_size=512)
JPARAMS = jax_init_reranker(jax.random.PRNGKey(0), CFG)
PARAMS = jax_params_to_torch(_flatten(JPARAMS), CFG, device="cpu")


def _tok(rng, n, length, real_len=None):
    """(tokens int32, mask float32) numpy with ids in [4, vocab) and
    ``real_len`` valid positions per row (all by default); padding is 0."""
    toks = rng.integers(4, CFG.vocab_size, (n, length)).astype(np.int32)
    lens = np.full(n, length) if real_len is None else np.asarray(real_len)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    return np.where(mask > 0, toks, 0).astype(np.int32), mask


def _t(*arrays):
    return [torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
            for a in arrays]


def test_reranker_params_convert_with_the_score_head():
    assert PARAMS["score_head"].dtype == torch.float32
    assert tuple(PARAMS["score_head"].shape) == (CFG.d_model, 1)
    np.testing.assert_array_equal(PARAMS["score_head"].numpy(), np.asarray(JPARAMS["score_head"]))
    init = reranker.init_reranker(CFG, torch.Generator().manual_seed(0), "cpu")
    assert set(init) == set(PARAMS) and init["score_head"].dtype == torch.float32


def test_llama_stack_reranker_is_minilm_wide():
    rr = model_configs("llama-3.1-8b")[3]
    assert rr == MINILM_CONFIG.replace(name="reranker", vocab_size=128_256)
    assert (rr.num_layers, rr.d_model, rr.num_heads) == (6, 384, 12)
    assert model_configs("serve-tiny", 512)[3] == CFG


@pytest.mark.parametrize("lens", [(None, None), ((5, 2, 7), (3, 6, 1))], ids=["full", "padded"])
def test_score_pairs_matches_jax(lens):
    rng = np.random.default_rng(1)
    ta, ma = _tok(rng, 3, 7, lens[0])
    tb, mb = _tok(rng, 3, 6, lens[1])
    want = np.asarray(jax_score_pairs(JPARAMS, *map(jnp.asarray, (ta, ma, tb, mb)), CFG))
    got = reranker.score_pairs(PARAMS, *_t(ta, ma, tb, mb), CFG).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", [(3, 0), (0, 5), (4, 2)])
def test_score_pairs_padding_independence(extra):
    rng = np.random.default_rng(3)
    ta, ma = _tok(rng, 2, 5)
    tb, mb = _tok(rng, 2, 4)
    ref = reranker.score_pairs(PARAMS, *_t(ta, ma, tb, mb), CFG)
    pad = lambda a, e: np.pad(a, ((0, 0), (0, e)))
    got = reranker.score_pairs(PARAMS, *_t(pad(ta, extra[0]), pad(ma, extra[0]),
                                           pad(tb, extra[1]), pad(mb, extra[1])), CFG)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_score_pairs_masked_tokens_are_invisible():
    rng = np.random.default_rng(5)
    ta, ma = _tok(rng, 2, 6, (3, 3))
    tb, mb = _tok(rng, 2, 6, (4, 4))
    ref = reranker.score_pairs(PARAMS, *_t(ta, ma, tb, mb), CFG)
    junk = rng.integers(4, CFG.vocab_size, ta.shape).astype(np.int32)
    got = reranker.score_pairs(PARAMS, *_t(np.where(ma > 0, ta, junk), ma, tb, mb), CFG)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_score_shortlist_matches_jax_and_per_pair():
    rng = np.random.default_rng(8)
    b, k, sq, sc = 2, 3, 5, 4
    qt, qm = _tok(rng, b, sq, (5, 3))
    ct = rng.integers(4, CFG.vocab_size, (b, k, sc)).astype(np.int32)
    cm = (rng.random((b, k, sc)) < 0.8).astype(np.float32)
    cm[:, :, 0] = 1.0
    want = np.asarray(jax_score_shortlist(JPARAMS, *map(jnp.asarray, (qt, qm, ct, cm)), CFG))
    got = reranker.score_shortlist(PARAMS, *_t(qt, qm, ct, cm), CFG)
    assert got.shape == (b, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for i in range(b):
        for j in range(k):
            ref = reranker.score_pairs(PARAMS, *_t(qt[i:i + 1], qm[i:i + 1], ct[i, j][None],
                                                   cm[i, j][None]), CFG)
            assert float(got[i, j]) == pytest.approx(float(ref[0]), rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 4), (3, 5)])
def test_score_shortlist_permutation_equivariant(seed, k):
    rng = np.random.default_rng(seed)
    qt, qm = _tok(rng, 2, 5)
    ct = rng.integers(4, CFG.vocab_size, (2, k, 4)).astype(np.int32)
    cm = np.ones((2, k, 4), np.float32)
    perm = rng.permutation(k)
    ref = reranker.score_shortlist(PARAMS, *_t(qt, qm, ct, cm), CFG)
    got = reranker.score_shortlist(PARAMS, *_t(qt, qm, ct[:, perm], cm[:, perm]), CFG)
    np.testing.assert_allclose(got.numpy(), ref.numpy()[:, perm], rtol=1e-4, atol=1e-5)
