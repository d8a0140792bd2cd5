"""The port's LM training path against the JAX package's on the CPU, fp32.

Same weights (JAX init, converted by ``checkpoint.jax_params_to_torch``),
same numpy inputs: the training forward, the cross entropy over a padded
vocabulary, the loss gradients, the flash wrapper's backward, train and
eval steps, the token stream, the checkpoint round trip back into JAX, the
train CLI and the config registry.

Tolerances (the two frameworks' CPU matmuls and transcendentals round
differently): logits 1e-4 absolute; losses 1e-5 relative; gradients 1e-4 of
each leaf's largest |g|; the attention backward 1e-5.  Train steps: each
loss 1e-5 relative; parameters 1e-5 absolute after three steps, except
where a gradient element is rounding noise: AdamW divides it by its own
magnitude (~lr * sign(g) at first), so such an element may move up to
2 * lr a step differently.  Under 0.1% of the elements may differ by more
than 1e-5, none by more than 2 * lr * steps (the rule of
``test_torch_training.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import load_checkpoint
from repro.checkpoint.checkpoint import _flatten
from repro.data import pretrain as jax_pretrain
from repro.models import ModelConfig as JaxModelConfig
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro.tokenizer import HashWordTokenizer as JaxTokenizer
from repro.training import optimizer as jax_opt
from repro.training import trainer as jax_trainer
from repro_torch import configs
from repro_torch.checkpoint import (jax_params_to_torch, latest_checkpoint, read_checkpoint,
                                    save_checkpoint, torch_param_dtypes, torch_params_to_jax)
from repro_torch.configs import llama31_8b
from repro_torch.data import pretrain, token_stream_batches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training import AdamWConfig, init_opt_state, make_eval_step, make_train_step
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import microbatch_value_and_grad, value_and_grad

SMOKE = llama31_8b.SMOKE_CONFIG                   # 2L d128 8H/2kv dh16, vocab 512, fp32
IMPLS = {"naive": SMOKE.replace(attention_impl="naive"),
         "xla_flash": SMOKE.replace(attention_impl="xla_flash", flash_block_q=32,
                                    flash_block_k=32)}
PADDED = SMOKE.replace(vocab_size=500)           # padded vocabulary 512


def _jax_cfg(cfg):
    return JaxModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _pair(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _batch(cfg, b=4, s=24, seed=0, partial=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    if partial:
        mask[:, : s // 3] = 0.0
        mask[0] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads_close(port_grads, jax_grads, cfg, rel):
    """Each port gradient leaf within ``rel`` of its largest |g| of the JAX
    gradient converted to the port's layout."""
    want = jax_params_to_torch(_flatten(jax_grads), cfg, device="cpu")
    got_leaves, want_leaves = tree_leaves(port_grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for got, ref in zip(got_leaves, want_leaves):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=rel * scale)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_forward_logits_match_jax(impl):
    cfg = IMPLS[impl]
    jm, jp, pm, pp = _pair(cfg)
    batch = _batch(cfg, s=40)
    want, jaux = jm.forward(jp, _j(batch))
    got, aux = pm.forward(pp, _t(batch))
    assert got.dtype == torch.float32 and got.shape == (4, 40, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_matches_jax_with_padded_vocab_and_partial_mask(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((3, 7, 512))).astype(np.float32)
    targets = rng.integers(0, 500, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    want = float(jax_tf.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                      jnp.asarray(mask), 500))
    got = float(tf.cross_entropy(torch.as_tensor(logits), torch.as_tensor(targets),
                                 torch.as_tensor(mask), 500))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the padded tail takes no probability: raising it leaves the loss alone
    lifted = logits.copy()
    lifted[..., 500:] += 50.0
    assert float(tf.cross_entropy(torch.as_tensor(lifted), torch.as_tensor(targets),
                                  torch.as_tensor(mask), 500)) == pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_loss_matches_jax_with_padded_vocab_and_partial_mask(impl):
    cfg = PADDED.replace(attention_impl=IMPLS[impl].attention_impl, flash_block_q=32,
                         flash_block_k=32)
    assert cfg.padded_vocab == 512
    jm, jp, pm, pp = _pair(cfg, seed=2)
    batch = _batch(cfg, partial=True)
    want, wm = jm.loss(jp, _j(batch))
    got, gm = pm.loss(pp, _t(batch))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(gm["ce"]) - float(wm["ce"])) <= 1e-5 * abs(float(wm["ce"]))
    assert int(gm["tokens"]) == int(wm["tokens"]) == int(batch["mask"].sum())


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_loss_gradients_match_jax(impl):
    cfg = IMPLS[impl]
    jm, jp, pm, pp = _pair(cfg, seed=3)
    batch = _batch(cfg, s=40, partial=True)
    jgrads = jax.grad(lambda p: jm.loss(p, _j(batch))[0])(jp)
    loss, _, grads = value_and_grad(pm, pp, _t(batch))
    assert all(not p.requires_grad for p in tree_leaves(pp))
    _grads_close(grads, jgrads, cfg, 1e-4)
    for layer in grads["layers"]:
        assert float(layer["attn"]["w_qkv"].abs().max()) > 0
        assert float(layer["attn"]["w_o"].abs().max()) > 0


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each block in the backward: memory, not
    numbers."""
    cfg = IMPLS["naive"]
    _, _, pm, pp = _pair(cfg, seed=4)
    batch = _t(_batch(cfg, s=32))
    l0, _, g0 = value_and_grad(pm, pp, batch)
    l1, _, g1 = value_and_grad(build_model(cfg.replace(remat=True)), pp, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("impl,block", [("naive", 32), ("xla_flash", 16), ("xla_flash", 32)])
def test_flash_backward_matches_jax_vjp(impl, block):
    """GQA with 4 query heads a KV head, queries after a 9-key prefix, and a
    query row (row 0 of batch 1) whose position precedes every key."""
    b, sq, pre, h, hk, dh = 2, 21, 9, 8, 2, 16
    rng = np.random.default_rng(block)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, pre + sq, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, pre + sq, hk, dh)).astype(np.float32)
    d_out = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(pre, pre + sq, dtype=np.int32), (b, sq)).copy()
    q_pos[1, 0] = -5
    k_pos = np.broadcast_to(np.arange(pre + sq, dtype=np.int32), (b, pre + sq)).copy()
    if impl == "naive":
        fn = lambda q_, k_, v_: jax_attention._attend_naive(q_, k_, v_, q_pos, k_pos, True, 0)
    else:
        fn = lambda q_, k_, v_: jax_attention._attend_xla_flash(q_, k_, v_, q_pos, k_pos,
                                                                True, 0, block, block)
    want_out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(d_out))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_ops.flash_attention(tq, tk, tv, torch.as_tensor(q_pos), torch.as_tensor(k_pos),
                                    causal=True, window=0, block_q=block, block_k=block,
                                    impl=impl)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(d_out))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    assert not got[0][1, 0].any()             # the row with no allowed key: dq 0


def test_flash_without_grad_is_the_plain_call():
    """Grad mode off (or no input needing grad): no autograd node, the same
    bits as before."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12).contiguous()
    kw = dict(causal=True, window=0, block_q=16, block_k=16, impl="xla_flash")
    plain = flash_ops.flash_attention(q, k, v, pos, pos, **kw)
    assert plain.grad_fn is None
    with torch.no_grad():
        nograd = flash_ops.flash_attention(q.requires_grad_(), k, v, pos, pos, **kw)
    assert nograd.grad_fn is None and torch.equal(nograd, plain)
    assert torch.equal(flash_ops.flash_attention(q, k, v, pos, pos, **kw).detach(), plain)


def _jax_steps(jm, jp, cfg, batches, microbatches, lr):
    step = jax.jit(jax_trainer.make_train_step(jm, jax_opt.AdamWConfig(lr=lr),
                                               microbatches=microbatches, warmup=2,
                                               total_steps=10))
    opt, losses = jax_opt.init_opt_state(jp), []
    for batch in batches:
        jp, opt, metrics = step(jp, opt, _j(batch))
        losses.append(float(metrics["loss"]))
    return jp, losses


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    cfg = IMPLS["naive"]
    lr = 1e-3
    jm, jp, pm, pp = _pair(cfg, seed=6)
    batches = [_batch(cfg, s=16, seed=10 + i) for i in range(3)]
    jp, want_losses = _jax_steps(jm, jp, cfg, batches, microbatches, lr)
    step = make_train_step(pm, AdamWConfig(lr=lr), microbatches=microbatches, warmup=2,
                           total_steps=10)
    opt, losses = init_opt_state(pp), []
    for batch in batches:
        pp, opt, metrics = step(pp, opt, _t(batch))
        assert isinstance(metrics["loss"], float)
        assert set(metrics) == ({"loss"} if microbatches > 1 else {"loss", "ce", "aux", "tokens"})
        losses.append(metrics["loss"])
    assert opt["step"] == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = jax_params_to_torch(_flatten(jp), cfg, device="cpu")
    diff = torch.cat([(got - ref).abs().flatten()
                      for got, ref in zip(tree_leaves(pp), tree_leaves(want))])
    assert float((diff > 1e-5).float().mean()) < 1e-3
    assert float(diff.max()) <= 2 * lr * len(batches)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_gradients_match_the_full_batch(microbatches):
    """The gradients a microbatched step applies (fp32, accumulated over the
    parts and divided by their count) against ``jax.grad`` of the whole
    batch, which they equal when every part holds as many unmasked tokens:
    each leaf within 1e-4 of its largest |g|, the loss within 1e-5."""
    cfg = IMPLS["naive"]
    jm, jp, pm, pp = _pair(cfg, seed=8)
    batch = _batch(cfg, s=16, seed=12)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, _j(batch))[0])(jp)
    loss, grads = microbatch_value_and_grad(pm, pp, _t(batch), microbatches)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(grads, jgrads, cfg, 1e-4)


def test_microbatch_split_must_divide_the_batch():
    cfg = IMPLS["naive"]
    pm = build_model(cfg)
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(pm, AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(pp, init_opt_state(pp), _t(_batch(cfg)))


def test_eval_step_matches_jax():
    cfg = IMPLS["xla_flash"]
    jm, jp, pm, pp = _pair(cfg, seed=7)
    batch = _batch(cfg, partial=True)
    want = jax_trainer.make_eval_step(jm)(jp, _j(batch))
    got = make_eval_step(pm)(pp, _t(batch))
    assert set(got) == set(want) == {"loss", "ce", "aux", "tokens"}
    for key in ("loss", "ce"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-5 * abs(float(want[key]))
    assert int(got["tokens"]) == int(want["tokens"])
    assert got["loss"].grad_fn is None


@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_batches_bitwise(seed):
    port = token_stream_batches(HashWordTokenizer(512), 4, 32, seed=seed)
    ref = jax_pretrain.token_stream_batches(JaxTokenizer(512), 4, 32, seed=seed)
    for _ in range(5):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    docs = pretrain.document_stream(seed)
    assert [next(docs) for _ in range(3)] == [
        d for d, _ in zip(jax_pretrain.document_stream(seed), range(3))]


def test_params_to_jax_inverts_the_converter():
    for cfg in (SMOKE, SMOKE.replace(mlp_type="gelu", norm_type="layernorm")):
        _, jp, _, pp = _pair(cfg, seed=8)
        flat, back = _flatten(jp), torch_params_to_jax(pp, cfg)
        assert back.keys() == flat.keys()
        for key in flat:
            assert back[key].shape == flat[key].shape
            assert np.array_equal(back[key], np.asarray(flat[key])), key


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Two port train steps, saved with the port's writer in the reference's
    layout; the JAX package's ``load_checkpoint`` restores it and its
    forward equals the port's."""
    cfg = IMPLS["naive"]
    jm, jp, pm, pp = _pair(cfg, seed=9)
    step = make_train_step(pm, AdamWConfig(lr=1e-2), warmup=1, total_steps=4)
    opt = init_opt_state(pp)
    for i in range(2):
        pp, opt, _ = step(pp, opt, _t(_batch(cfg, s=16, seed=20 + i)))
    path = save_checkpoint(str(tmp_path), 2, torch_params_to_jax(pp, cfg), {"arch": cfg.name},
                           dtypes=torch_param_dtypes(pp, cfg))
    assert path.endswith("step_2") and latest_checkpoint(str(tmp_path)) == 2
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    restored, meta = load_checkpoint(str(tmp_path), 2, jp)
    assert meta["metadata"] == {"arch": cfg.name}
    batch = _batch(cfg, s=30, seed=30)
    want, _ = jm.forward(restored, _j(batch))
    got, _ = pm.forward(pp, _t(batch))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_bf16_leaves_are_restored_as_bf16(tmp_path):
    cfg = SMOKE.replace(dtype="bfloat16")
    jm, jp, pm, _ = _pair(cfg, seed=10)
    pp = pm.init(torch.Generator().manual_seed(1), "cpu")
    dtypes = torch_param_dtypes(pp, cfg)
    assert dtypes["embed"] == "bfloat16" and dtypes["final_norm/scale"] == "float32"
    save_checkpoint(str(tmp_path), 1, torch_params_to_jax(pp, cfg), dtypes=dtypes)
    flat, meta = read_checkpoint(str(tmp_path), 1)
    assert flat["embed"].dtype == np.float32 and meta["dtypes"]["embed"] == "bfloat16"
    restored, _ = load_checkpoint(str(tmp_path), 1, jp)
    assert restored["embed"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(restored["embed"], np.float32), pp["embed"].float().numpy())
    assert restored["scan"][0]["norm1"]["scale"].dtype == jnp.float32


def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    rc = train_cli.main(["--device", "cpu", "--steps", "20", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.startswith("arch=llama-3.1-8b ") and "(improved)" in out
    assert "step    0 loss" in out and "step   19 loss" in out
    assert latest_checkpoint(str(tmp_path)) == 20
    jm = jax_build_model(_jax_cfg(SMOKE))
    restored, meta = load_checkpoint(str(tmp_path), 20, jm.init(jax.random.PRNGKey(0)))
    assert meta["metadata"] == {"arch": "llama-3.1-8b"}
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(restored))


@pytest.mark.parametrize("arch", sorted(jax_configs._MODULES))
def test_config_registry(arch):
    """The reference's ids: those the port builds resolve to copies of the
    reference's configs; the rest raise, naming what they lack."""
    if arch in configs.MISSING:
        with pytest.raises(NotImplementedError, match=arch):
            configs.get_config(arch)
        with pytest.raises(NotImplementedError):
            configs.skip_reason(arch, "long_500k")
        return
    for smoke in (False, True):
        got, want = configs.get_config(arch, smoke), jax_configs.get_config(arch, smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        tf.check_supported(got)
    assert configs.skip_reason(arch, "long_500k") == jax_configs.skip_reason(arch, "long_500k")


def test_config_registry_covers_the_reference():
    assert set(configs._MODULES) | set(configs.MISSING) == set(jax_configs._MODULES)
    assert not set(configs._MODULES) & set(configs.MISSING)
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
