"""The port's AdamW and trainers against the JAX package's on the same inputs.

AdamW is fed the same gradients (fp32 and bf16 parameters, the global-norm
clip active and not); the losses and their gradients run on JAX parameters
converted with ``checkpoint.convert``; the trainers run 3 steps from the same
converted parameters on the same generated batches.

Tolerances.  AdamW: parameters and moments within 1e-6 a step.  Losses and
gradients: within 1e-5 of the loss, and of each leaf's largest gradient
(frameworks sum in different orders).  Trainers: every step's loss within
1e-4 relative; parameters may differ where a gradient is rounding noise,
because AdamW's early steps are ~lr * sign(g): an element whose gradient
sign differs between frameworks moves up to 2 * lr a step the other way.
So under 0.1% of the elements may differ by more than 1e-5, and none by
more than 2 * lr * steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.data.questions import QuestionPairGenerator as JaxPairs
from repro.models.embedder import init_embedder as jax_init_embedder
from repro.models.reranker import init_reranker as jax_init_reranker
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro.training import embedder_train as jax_emb_train
from repro.training import optimizer as jax_opt
from repro.training import reranker_train as jax_rr_train
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.data import QuestionPairGenerator
from repro_torch.models.embedder import tiny_embedder_config
from repro_torch.models.reranker import tiny_reranker_config
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training import embedder_train, optimizer, reranker_train
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

VOCAB = 512


def _tree(rng):
    return {"w": rng.standard_normal((6, 8)).astype(np.float32),
            "blocks": {"a": rng.standard_normal((3, 5)).astype(np.float32),
                       "b": rng.standard_normal((16,)).astype(np.float32)},
            "head": rng.standard_normal((8, 1)).astype(np.float32)}


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        tree.float().numpy() if isinstance(tree, torch.Tensor)
        else np.asarray(tree, np.float32))


def _close(port_tree, jax_tree, atol, what):
    p, j = _np(port_tree), _np(jax_tree)
    for k in j:
        if isinstance(j[k], dict):
            _close(port_tree[k], jax_tree[k], atol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=atol, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_matches_jax_on_fed_gradients(dtype, grad_scale):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), p0)
    tp = optimizer.tree_map(lambda a: torch.from_numpy(a).to(td), p0)
    cfg = dict(lr=1e-2, weight_decay=0.1)
    jcfg, tcfg = jax_opt.AdamWConfig(**cfg), optimizer.AdamWConfig(**cfg)
    jst, tst = jax_opt.init_opt_state(jp), optimizer.init_opt_state(tp)
    norms = []
    for step in range(5):
        g = jax.tree.map(lambda a: a * grad_scale, _tree(rng))
        norms.append(float(jax_opt.global_norm(g)))
        jp, jst = jax_opt.adamw_update(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        tp, tst = optimizer.adamw_update(tp, optimizer.tree_map(torch.from_numpy, g), tst,
                                         tcfg)
        assert tst["step"] == int(jst["step"]) == step + 1
        assert all(t.dtype == td for t in optimizer.tree_leaves(tp))
        _close(tp, jp, 1e-6, f"step {step} params")
        _close(tst["m"], jst["m"], 1e-6, f"step {step} m")
        _close(tst["v"], jst["v"], 1e-6, f"step {step} v")
    assert (min(norms) > tcfg.grad_clip) == (grad_scale > 1)   # the clip acts, or never


def test_global_norm_covers_every_leaf():
    tree = optimizer.tree_map(torch.from_numpy, _tree(np.random.default_rng(1)))
    want = np.sqrt(sum(float((t.double() ** 2).sum()) for t in optimizer.tree_leaves(tree)))
    assert len(optimizer.tree_leaves(tree)) == 4
    assert float(optimizer.global_norm(tree)) == pytest.approx(want, rel=1e-6)


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 40, dtype=np.int32)
    for warmup, total, floor in ((5, 25, 0.1), (0, 10, 0.0), (8, 8, 0.2)):
        want = np.asarray(jax_opt.cosine_schedule(jnp.asarray(steps), warmup=warmup,
                                                  total=total, floor=floor))
        got = optimizer.cosine_schedule(torch.from_numpy(steps), warmup=warmup, total=total,
                                        floor=floor).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _embedder():
    cfg = tiny_embedder_config(VOCAB)
    jp = jax_init_embedder(jax.random.PRNGKey(0), cfg)
    return cfg, jp


def _reranker():
    cfg = tiny_reranker_config(VOCAB)
    jp = jax_init_reranker(jax.random.PRNGKey(1), cfg)
    return cfg, jp


def _port(jp, cfg):
    return jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _grads_close(loss_p, params_p, loss_j, grads_j, cfg):
    assert loss_p.item() == pytest.approx(float(loss_j), rel=1e-5)
    want = _port(grads_j, cfg)
    got = optimizer.tree_map(lambda p: p.grad, params_p)
    for g, w in zip(optimizer.tree_leaves(got), optimizer.tree_leaves(want)):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * max(scale, 1e-12)


def test_info_nce_loss_and_gradients_match_jax():
    cfg, jp = _embedder()
    tok = HashWordTokenizer(VOCAB)
    batch = embedder_train.triple_batch(QuestionPairGenerator(seed=3), tok, 6, 16, "cpu")
    jargs = [jnp.asarray(t.numpy().astype(np.int32 if t.dtype == torch.int64 else np.float32))
             for t in batch]
    loss_j, grads_j = jax.value_and_grad(jax_emb_train.info_nce_loss)(jp, cfg, *jargs)
    params = _port(jp, cfg)
    for p in optimizer.tree_leaves(params):
        p.requires_grad_(True)
    loss_p = embedder_train.info_nce_loss(params, cfg, *batch)
    loss_p.backward()
    _grads_close(loss_p, params, loss_j, grads_j, cfg)


def test_pair_bce_loss_and_gradients_match_jax():
    cfg, jp = _reranker()
    tok = HashWordTokenizer(VOCAB)
    batch = reranker_train.pair_batch(QuestionPairGenerator(seed=5), tok, 8, 12, 0.5, "cpu")
    jargs = [jnp.asarray(t.numpy().astype(np.int32 if t.dtype == torch.int64 else np.float32))
             for t in batch]
    loss_j, grads_j = jax.value_and_grad(jax_rr_train.pair_bce_loss)(jp, cfg, *jargs)
    params = _port(jp, cfg)
    for p in optimizer.tree_leaves(params):
        p.requires_grad_(True)
    loss_p = reranker_train.pair_bce_loss(params, cfg, *batch)
    loss_p.backward()
    _grads_close(loss_p, params, loss_j, grads_j, cfg)
    assert params["score_head"].grad.shape == (cfg.d_model, 1)


def _trained_close(port_params, jax_params, cfg, lr, steps):
    want = _port(jax_params, cfg)
    diffs = np.concatenate([(g - w).abs().flatten().numpy() for g, w in
                            zip(optimizer.tree_leaves(port_params),
                                optimizer.tree_leaves(want))])
    assert float((diffs > 1e-5).mean()) < 1e-3
    assert float(diffs.max()) <= 2 * lr * steps


@pytest.mark.parametrize("which", ["embedder", "reranker"])
def test_trainer_three_steps_match_jax(which):
    lr, steps = 1e-3, 3
    if which == "embedder":
        cfg, jp = _embedder()
        train_j, train_p = jax_emb_train.train_embedder, embedder_train.train_embedder
        kw = dict(steps=steps, batch=8, max_len=16, lr=lr, seed=2)
    else:
        cfg, jp = _reranker()
        train_j, train_p = jax_rr_train.train_reranker, reranker_train.train_reranker
        kw = dict(steps=steps, batch=8, max_len=12, lr=lr, seed=2)
    params = _port(jp, cfg)
    jp, losses_j = train_j(jp, cfg, JaxTokenizer(VOCAB), **kw)
    params, losses_p = train_p(params, cfg, HashWordTokenizer(VOCAB), **kw)
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert not any(p.requires_grad for p in optimizer.tree_leaves(params))
    _trained_close(params, jp, cfg, lr, steps)


def test_batches_are_the_reference_batches():
    """The port's generator and tokenizer copies give the reference's batch."""
    tok, jtok = HashWordTokenizer(VOCAB), JaxTokenizer(VOCAB)
    batch = embedder_train.triple_batch(QuestionPairGenerator(seed=7), tok, 4, 16, "cpu")
    jg = JaxPairs(seed=7)
    triples = [jg.triple() for _ in range(4)]
    for j in range(3):
        t, m = jtok.encode_batch([tr[j].text for tr in triples], 16)
        assert np.array_equal(batch[2 * j].numpy(), t)
        assert np.array_equal(batch[2 * j + 1].numpy(), m)
