"""The port on an NVIDIA GPU: each Hopper kernel against its plain PyTorch
version, and small engines (dense; paged with a speculating small model; an
IVF bank) served on the card against the same engines on the CPU.  Every
test is marked ``cuda`` and skips without a card.  This file imports no JAX,
so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 kernels 1e-5 (summation order differs from the plain
version's); bf16 2e-2 (bf16 output rounding, ulp 2**-8 near 1).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.core.tweak import preprocess_query
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cosine_topk import ops as cos_ops
from repro_torch.kernels.cosine_topk.ref import cosine_topk_gather_ref, cosine_topk_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_block_ref
from repro_torch.kernels.flash_attention.ref import attend_blockwise, attend_naive
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (paged_decode_attention_block_ref,
                                                     paged_decode_attention_ref)
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.models.embedder import init_embedder
from repro_torch.models.transformer import attention_layers
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]
DENSE_PATH = ("flash_attention", "decode_attention", "cosine_topk")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -q -m cuda "
                    "tests/test_torch_cuda.py on the card)")
    return torch.device("cuda")


def _profiled_kernels(fn, calls):
    """(kernel name, launches) of ``calls`` calls of ``fn`` under
    torch.profiler.  The profiler drops a kernel record whose start, on the
    host clock, falls before the session began, and the card's records can
    land a few ms before their launch; once the process has trained on the
    card it drops the first few records of every session.  So the session
    waits 20 ms, then opens with 32 sentinel kernels (``torch.cuda._sleep``,
    left out of the result, as ``chip_smoke.device_ms`` does) and a sync."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(32):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,p,s,h,hk,dh,block,window", [
    (2, 45, 64, 8, 2, 128, 64, 0),     # TWEAK suffix over a stored prefix
    (3, 0, 37, 4, 4, 64, 32, 0),       # ragged plain prefill
    (1, 10, 50, 8, 4, 64, 16, 12),     # sliding window
    (8, 45, 128, 32, 8, 128, 64, 0),   # llama-3.1-8b TWEAK suffix (xla_flash, block 64)
    (8, 0, 64, 32, 8, 128, 128, 0),    # llama-3.1-8b MISS prefill
    (2, 150, 40, 8, 2, 128, 64, 20),   # window: key tiles [0, 128) masked for every row
])
def test_flash_kernel_matches_plain(impl, dtype, tol, b, p, s, h, hk, dh, block, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(p + s)
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, p + s, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, p + s, hk, dh, device=dev, generator=g).to(dtype)
    q_pos = torch.arange(p, p + s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    k_pos = torch.arange(p + s, device=dev, dtype=torch.int32).expand(b, p + s).contiguous()
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                                    block_q=block, block_k=block, impl=impl)
    assert flash_ops.launches == before + 1
    f = [x.float() for x in (q, k, v)]
    torch.testing.assert_close(out.float(), attend_blockwise(*f, q_pos, k_pos, True, window,
                                                             block, block), rtol=tol, atol=tol)
    torch.testing.assert_close(out.float(), attend_naive(*f, q_pos, k_pos, True, window),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_autograd_matches_plain_autograd(impl, dtype, tol, dh):
    """The differentiable wrapper (kernel forward, plain backward) against
    autograd of the plain version on fp32 copies: GQA g 4, queries after a
    9-key prefix, one query row with no allowed key.  Output within the
    kernel's tolerance, each gradient within ``tol`` of its largest |g|
    (fp32 1e-4; bf16 2e-2, the gradients rounded to bf16)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(dh)
    b, pre, s, h, hk, block = 2, 9, 70, 8, 2, 64
    q, k, v = (torch.randn(b, n, heads, dh, device=dev, generator=g).to(dtype).requires_grad_()
               for n, heads in ((s, h), (pre + s, hk), (pre + s, hk)))
    d_out = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    q_pos = torch.arange(pre, pre + s, device=dev, dtype=torch.int32).expand(b, s).clone()
    q_pos[1, 0] = -5
    k_pos = torch.arange(pre + s, device=dev, dtype=torch.int32).expand(b, pre + s).contiguous()
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=0,
                                    block_q=block, block_k=block, impl=impl)
    got = torch.autograd.grad(out, (q, k, v), d_out)
    assert flash_ops.launches == before + 1
    f = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want_out = (attend_naive(*f, q_pos, k_pos, True, 0) if impl == "naive" else
                attend_blockwise(*f, q_pos, k_pos, True, 0, block, block))
    want = torch.autograd.grad(want_out, f, d_out.float())
    ftol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().float(), want_out.detach(), rtol=0, atol=ftol)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        scale = float(w.abs().max())
        torch.testing.assert_close(a.float(), w, rtol=0, atol=tol * scale, msg=name)
    assert not got[0][1, 0].any()


@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("b,p,s,h,hk,window", [(2, 0, 40, 8, 2, 0), (3, 9, 33, 4, 4, 12)])
def test_flash_fp32_head_dim_16_matches_plain(impl, b, p, s, h, hk, window):
    """The fp32 CUDA-core body at head dim 16, the reference's smoke configs'
    (the train CLI's default on the card); bf16 keeps 64 and 128 only."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, s, h, 16, device=dev, generator=g)
    k, v = (torch.randn(b, p + s, hk, 16, device=dev, generator=g) for _ in range(2))
    q_pos = torch.arange(p, p + s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    k_pos = torch.arange(p + s, device=dev, dtype=torch.int32).expand(b, p + s).contiguous()
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                                    block_q=16, block_k=16, impl=impl)
    want = (attend_naive(q, k, v, q_pos, k_pos, True, window) if impl == "naive" else
            attend_blockwise(q, k, v, q_pos, k_pos, True, window, 16, 16))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_ops.flash_attention(*(x.bfloat16() for x in (q, k, v)), q_pos, k_pos,
                                  causal=True, window=0, block_q=16, block_k=16, impl=impl)


def test_train_cli_smoke_on_the_card(tmp_path, capsys):
    """The train CLI's defaults (qwen2.5-3b's smoke config, fp32 flash at dh
    32) on the card: the loss falls, the flash kernel runs every layer
    forward, a checkpoint is written."""
    from repro_torch.checkpoint import latest_checkpoint
    from repro_torch.launch import train
    _cuda()
    before = flash_ops.launches
    rc = train.main(["--steps", "20", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    assert flash_ops.launches - before == 20 * 2          # 2 layers, no remat
    assert latest_checkpoint(str(tmp_path)) == 20


def test_flash_without_grad_is_the_launch_alone():
    """Grad mode off: the wrapper is the kernel launch of before, bit for
    bit, whatever the inputs' requires_grad; with grad the forward is the
    same launch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    b, pre, s, h, hk, dh = 8, 45, 128, 32, 8, 128
    q = torch.randn(b, s, h, dh, device=dev, generator=g, dtype=torch.bfloat16)
    k, v = (torch.randn(b, pre + s, hk, dh, device=dev, generator=g, dtype=torch.bfloat16)
            for _ in range(2))
    q_pos = torch.arange(pre, pre + s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    k_pos = torch.arange(pre + s, device=dev, dtype=torch.int32).expand(b, pre + s).contiguous()
    args = (q_pos, k_pos, True, 0, 64, 64, "xla_flash")
    direct = flash_ops._forward(q, k, v, *args)
    kw = dict(causal=True, window=0, block_q=64, block_k=64, impl="xla_flash")
    before = flash_ops.launches
    with torch.no_grad():
        quiet = flash_ops.flash_attention(q.requires_grad_(), k, v, q_pos, k_pos, **kw)
    assert flash_ops.launches == before + 1 and quiet.grad_fn is None
    assert torch.equal(quiet, direct)
    graded = flash_ops.flash_attention(q, k, v, q_pos, k_pos, **kw)
    assert graded.grad_fn is not None and torch.equal(graded.detach(), direct)
    assert flash_ops.launches == before + 2


def _lm_on_the_card(dtype):
    """A 2-layer LM the kernel takes (dh 64), weights drawn on the CPU."""
    from repro_torch.configs import llama31_8b
    cfg = llama31_8b.SMOKE_CONFIG.replace(d_model=256, num_heads=4, num_kv_heads=2,
                                          head_dim=64, d_ff=512, dtype=dtype,
                                          attention_impl="naive")
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _lm_batch(cfg, device, b=4, s=64):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1].to(device), "targets": toks[:, 1:].to(device),
            "mask": torch.ones(b, s, device=device)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_backward_on_the_card(dtype):
    """The same gradients with ``remat`` on and off; the recompute launches
    the flash kernel once more a layer."""
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.trainer import value_and_grad
    dev = _cuda()
    cfg, model, params = _lm_on_the_card(dtype)
    params = tree_map(lambda t: t.to(dev), params)
    batch = _lm_batch(cfg, dev)
    runs = []
    for remat in (False, True):
        before = flash_ops.launches
        loss, _, grads = value_and_grad(build_model(cfg.replace(remat=remat)), params, batch)
        runs.append((float(loss), grads, flash_ops.launches - before))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert (n0, n1) == (cfg.num_layers, 2 * cfg.num_layers)
    assert l0 == l1
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(a.abs().max().float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_step_trains_the_attention_weights(dtype):
    """A loss through ``self_attention`` on the card gives every layer
    non-zero ``w_qkv`` and ``w_o`` gradients, equal to autograd of the plain
    version (the same loss on the CPU): fp32 within 1e-4, bf16 within 5e-2
    of each leaf's largest |g| (bf16 activations through two layers); then
    a train step runs."""
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.trainer import value_and_grad
    dev = _cuda()
    cfg, model, params = _lm_on_the_card(dtype)
    card = tree_map(lambda t: t.to(dev), params)
    _, _, g_cpu = value_and_grad(model, params, _lm_batch(cfg, "cpu"))
    before = flash_ops.launches
    _, _, g_card = value_and_grad(model, card, _lm_batch(cfg, dev))
    assert flash_ops.launches == before + cfg.num_layers
    tol = 1e-4 if dtype == "float32" else 5e-2
    for layer in g_card["layers"]:
        assert float(layer["attn"]["w_qkv"].abs().max()) > 0
        assert float(layer["attn"]["w_o"].abs().max()) > 0
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        torch.testing.assert_close(a.float().cpu(), b.float(), rtol=0,
                                   atol=tol * float(b.abs().max().float()))
    step = make_train_step(model, AdamWConfig(lr=1e-3), total_steps=4)
    _, opt, metrics = step(card, init_opt_state(card), _lm_batch(cfg, dev))
    assert opt["step"] == 1 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_row_with_no_allowed_key(impl, dtype, tol, dh):
    """Queries whose positions precede every key (and a window that excludes
    the rest) have no allowed key: the reference gives the uniform average
    of V over the padded keys, also where the kernel skipped masked tiles."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(dh)
    b, s, sk, h, hk, block = 2, 40, 150, 8, 2, 64
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    q_pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    q_pos = torch.where(q_pos < 24, q_pos - 1000, q_pos + 100)    # rows 0-23: no key
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(b, sk).contiguous()
    for window in (0, 30):
        out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                                        block_q=block, block_k=block, impl=impl)
        f = [x.float() for x in (q, k, v)]
        want = (attend_naive(*f, q_pos, k_pos, True, window) if impl == "naive" else
                attend_blockwise(*f, q_pos, k_pos, True, window, block, block))
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl,block", [("naive", 64), ("xla_flash", 16)])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_keys_past_sk_pad_take_no_weight(impl, block, dtype, tol, dh):
    """Without a causal mask every key up to Sk_pad is allowed (past Sk as a
    zero key at position 2**30), and none beyond it: Sk 50 ends inside a
    kernel key tile under both impls."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(dh + block)
    b, s, sk, h, hk = 2, 37, 50, 8, 2
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    q_pos = torch.arange(13, sk, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(b, sk).contiguous()
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=False, window=0,
                                    block_q=block, block_k=block, impl=impl)
    f = [x.float() for x in (q, k, v)]
    want = (attend_naive(*f, q_pos, k_pos, False, 0) if impl == "naive" else
            attend_blockwise(*f, q_pos, k_pos, False, 0, block, block))
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,hk,dh,prefix,s", [(8, 32, 8, 128, 45, 128),
                                                (2, 8, 2, 64, 30, 100)])
def test_flash_suffix_is_bitwise_the_full_prefill(b, h, hk, dh, prefix, s):
    """Queries [P, P+S) over keys [0, P+S) give bit for bit the last S rows of
    queries [0, P+S) over the same K/V (bf16, xla_flash block 64): a row's
    arithmetic depends on neither Sq nor the rows that share its block."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(prefix + s)
    sk = prefix + s
    q = torch.randn(b, sk, h, dh, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(b, sk).contiguous()
    run = lambda qq, qp: flash_ops.flash_attention(qq, k, v, qp, pos, causal=True, window=0,
                                                   block_q=64, block_k=64, impl="xla_flash")
    full = run(q, pos)
    suffix = run(q[:, prefix:].contiguous(), pos[:, prefix:].contiguous())
    assert torch.equal(suffix, full[:, prefix:])


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,h,hk,t,dh", [(8, 32, 8, 300, 128), (8, 32, 8, 97, 128),
                                         (2, 8, 8, 50, 64), (3, 8, 1, 700, 128)])
def test_decode_kernel_matches_plain(dtype, tol, b, h, hk, t, dh):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(b, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    lens = torch.randint(1, t + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t
    out = dec_ops.decode_attention(q, k, v, lens)
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("b,h,hk,t,dh", [(8, 32, 8, 206, 128), (3, 8, 1, 700, 128),
                                         (2, 16, 2, 45, 64)])
def test_decode_block_kernel_matches_plain(dtype, tol, kq, b, h, hk, t, dh):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t + kq)
    q = torch.randn(b, kq, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    lens = torch.randint(0, t - kq + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t - kq
    before = dec_ops.block_launches
    out = dec_ops.decode_attention_block(q, k, v, lens)
    torch.cuda.synchronize()
    assert dec_ops.block_launches == before + 1
    ref = decode_attention_block_ref(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


def _dense_case(dev, seed, b, kq, h, hk, t, dh, dtype):
    """q (B,H,dh) for kq 0, else (B,K,H,dh), and a dense cache k/v (B,T,Hk,dh)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, h, dh) if kq == 0 else (b, kq, h, dh)
    q = torch.randn(*shape, device=dev, generator=g).to(dtype)
    k = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, t, hk, dh, device=dev, generator=g).to(dtype)
    return q, k, v


def _dense_both(q, k, v, lens, kq):
    """The kernel and the plain version (fp32) of the single-token kernel
    (kq 0, ``t < lens``) or the verify block (``t < lens + i + 1``)."""
    f = [x.float() for x in (q, k, v)]
    if kq == 0:
        return dec_ops.decode_attention(q, k, v, lens), decode_attention_ref(*f, lens)
    return dec_ops.decode_attention_block(q, k, v, lens), decode_attention_block_ref(*f, lens)


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_decode_kernel_uniform_at_cache_len_zero(dtype, tol):
    """A row with cache_len 0 (every slot masked) gets the plain version's
    uniform average of V over all T slots, on both routes; the other rows
    are unchanged by it."""
    dev = _cuda()
    q, k, v = _dense_case(dev, 3, 4, 0, 32, 8, 97, 128, dtype)
    lens = torch.tensor([0, 5, 0, 97], device=dev, dtype=torch.int32)
    out, ref = _dense_both(q, k, v, lens, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    mean = v.float().mean(1).repeat_interleave(4, dim=1)          # (B,H,dh)
    torch.testing.assert_close(out[0].float(), mean[0], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("kq", [0, 1, 4])
@pytest.mark.parametrize("t", [45, 97, 206])
def test_dense_kernels_ragged_t_and_a_full_cache(dtype, tol, kq, t):
    """T not a multiple of 64 (the last tile ragged), and rows whose last
    query sees the whole cache (decode: cache_len == T; the block:
    cache_len + K == T) beside ragged ones."""
    dev = _cuda()
    q, k, v = _dense_case(dev, t + kq, 3, kq, 16, 4, t, 128, dtype)
    full = t - max(kq, 1) + (kq == 0)
    lens = torch.tensor([full, full // 2, 1], device=dev, dtype=torch.int32)
    out, ref = _dense_both(q, k, v, lens, kq)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kq", [0, 4])
@pytest.mark.parametrize("b,hk,t,splits", [(1, 1, 4096, 8), (40, 8, 300, 1)])
def test_dense_kernels_one_and_eight_splits(kq, b, hk, t, splits):
    """bf16: a long cache of one row and one KV head runs 8 splits, one
    cluster merging through distributed shared memory; many rows run one
    split that writes its output directly."""
    dev = _cuda()
    assert dec_ops.launch_plan(b, max(kq, 1), t, hk, 4, 128, torch.bfloat16).splits == splits
    q, k, v = _dense_case(dev, t + kq, b, kq, 4 * hk, hk, t, 128, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(b)
    lens = torch.randint(1, t - kq + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t - kq
    out, ref = _dense_both(q, k, v, lens, kq)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kq", [0, 1, 4])
def test_dense_kernels_repeat_bit_for_bit(kq):
    """bf16 at the main shapes (B 8, H 32 / Hk 8, dh 128, T 206: 2 splits
    merged in their cluster): three calls equal bit for bit."""
    dev = _cuda()
    q, k, v = _dense_case(dev, 11 + kq, 8, kq, 32, 8, 206, 128, torch.bfloat16)
    lens = torch.full((8,), 189, device=dev, dtype=torch.int32)
    outs = [_dense_both(q, k, v, lens, kq)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _pages_of(x, tbl, page):
    """A (P+1,page,Hk,dh) pool holding dense rows x (B,T,Hk,dh) through the
    block table: logical slot t of row b in page tbl[b, t // page]."""
    b, t, hk, dh = x.shape
    npg = tbl.shape[1]
    pool = torch.zeros(b * npg + 1, page, hk, dh, device=x.device, dtype=x.dtype)
    padded = torch.zeros(b, npg * page, hk, dh, device=x.device, dtype=x.dtype)
    padded[:, :t] = x
    pool[tbl.long().flatten()] = padded.view(b * npg, page, hk, dh)
    return pool


@pytest.mark.parametrize("kq", [0, 1, 4])
def test_dense_and_paged_kernels_agree_bit_for_bit(kq):
    """bf16, a dense cache and a page pool holding the same rows at cap == T
    (206, pages of 16 in a permuted table), ragged lengths: both read
    through the same tensor-core body with the same cut and the same tiles,
    so decode (kq 0) and the verify block (K 1, 4) agree bit for bit."""
    dev = _cuda()
    b, h, hk, dh, t, page = 8, 32, 8, 128, 206, 16
    q, k, v = _dense_case(dev, 5 + kq, b, kq, h, hk, t, dh, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(kq)
    npg = -(-t // page)
    tbl = torch.randperm(b * npg, device=dev, generator=g).view(b, npg).to(torch.int32)
    kp, vp = _pages_of(k, tbl, page), _pages_of(v, tbl, page)
    lens = torch.randint(1, t - max(kq, 1) + 1, (b,), device=dev, generator=g,
                         dtype=torch.int32)
    lens[0] = t - max(kq, 1)
    slots = torch.arange(t, device=dev)[None, :]
    seen = lens + kq              # decode (kq 0): t < lens; the block: t < lens + K
    sp = torch.where(slots < seen[:, None], slots, -1).to(torch.int32).contiguous()
    if kq == 0:
        dense = dec_ops.decode_attention(q, k, v, lens)
        paged = paged_ops.paged_decode_attention(q, kp, vp, tbl, sp)
    else:
        dense = dec_ops.decode_attention_block(q, k, v, lens)
        paged = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, lens)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)


def test_dense_kernels_launch_once_and_allocate_only_the_output():
    """bf16 at the main shapes: one kernel launch per call (the splits merge
    in their cluster, no second launch) and one allocation, the output (no
    scratch)."""
    dev = _cuda()
    for kq in (0, 4):
        q, k, v = _dense_case(dev, 7, 8, kq, 32, 8, 206, 128, torch.bfloat16)
        lens = torch.full((8,), 189, device=dev, dtype=torch.int32)
        _dense_both(q, k, v, lens, kq)
        torch.cuda.synchronize()
        call = dec_ops.decode_attention if kq == 0 else dec_ops.decode_attention_block
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        call(q, k, v, lens)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == before + 1
        kernels = _profiled_kernels(lambda: call(q, k, v, lens), 3)
        assert len(kernels) == 1 and kernels[0][1] == 3, kernels
        assert "panel_mma_kernel" in kernels[0][0], kernels


@pytest.mark.parametrize("kq", [0, 4])
def test_dense_kernels_raise_on_a_misaligned_bf16_input(kq):
    """cp.async needs 16-byte aligned q and cache on the bf16 route: a
    contiguous view two bytes off raises before any launch."""
    dev = _cuda()
    q, k, v = _dense_case(dev, 9, 2, kq, 8, 2, 64, 64, torch.bfloat16)
    lens = torch.full((2,), 10, device=dev, dtype=torch.int32)
    call = dec_ops.decode_attention if kq == 0 else dec_ops.decode_attention_block

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    before = (dec_ops.launches, dec_ops.block_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(shifted(q), k, v, lens)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(q, shifted(k), v, lens)
    assert (dec_ops.launches, dec_ops.block_launches) == before
    _dense_both(q, k, v, lens, kq)   # the aligned call runs


def _paged_case(dev, g, b, kq, h, hk, dh, page, cap, dtype):
    """A pool with a prefix of two pages shared by every row (pinned), then
    private pages; ragged per-row lengths; the last row parked on TRASH."""
    npg = -(-cap // page)
    pages = 2 + b * (npg - 2) + 1
    kp = torch.randn(pages + 1, page, hk, dh, device=dev, generator=g).to(dtype)
    vp = torch.randn(pages + 1, page, hk, dh, device=dev, generator=g).to(dtype)
    perm = torch.randperm(pages - 2, device=dev, generator=g)[:b * (npg - 2)] + 2
    tbl = torch.cat([torch.arange(2, device=dev).expand(b, 2), perm.view(b, npg - 2)], 1)
    tbl = tbl.to(torch.int32).contiguous()
    tbl[-1] = pages                                        # TRASH
    qpos = torch.randint(2 * page, cap - kq + 1, (b,), device=dev, generator=g,
                         dtype=torch.int32)
    t = torch.arange(cap, device=dev)[None, :]
    sp = torch.where(t < (qpos + kq)[:, None], t, -1).to(torch.int32)
    sp[:, 5] = -1                                          # a rewound hole
    sp[-1] = -1
    q = torch.randn(b, kq, h, dh, device=dev, generator=g).to(dtype)
    return q, kp, vp, tbl, sp.contiguous(), qpos


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("kq", [1, 2, 3, 4])
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("b,h,hk,dh,cap", [(8, 32, 8, 128, 206), (3, 8, 2, 64, 75),
                                           (2, 8, 8, 128, 150), (3, 16, 8, 64, 75),
                                           (2, 16, 2, 128, 300)])
def test_paged_kernels_match_plain(dtype, tol, kq, page, b, h, hk, dh, cap):
    """Rows with at least one valid slot against the plain versions, at G 4,
    1, 2 and 8 and K 1-4 (panels that do not fill their n-tiles); the TRASH
    row with none gives exactly 0 (the kernels' rule)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(cap + page + kq)
    q, kp, vp, tbl, sp, qpos = _paged_case(dev, g, b, kq, h, hk, dh, page, cap, dtype)
    before = paged_ops.block_launches
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    torch.cuda.synchronize()
    assert paged_ops.block_launches == before + 1
    f = [x.float() for x in (q, kp, vp)]
    ref = paged_decode_attention_block_ref(f[0], f[1], f[2], tbl, sp, qpos)
    torch.testing.assert_close(out[:-1].float(), ref[:-1], rtol=tol, atol=tol)
    assert bool(torch.isfinite(out[-1].float()).all()) and not out[-1].float().abs().max()
    if kq == 1:
        one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
        ref1 = paged_decode_attention_ref(f[0][:, 0], f[1], f[2], tbl, sp)
        torch.testing.assert_close(one[:-1].float(), ref1[:-1], rtol=tol, atol=tol)
        assert bool(torch.isfinite(one.float()).all())


# ---------------------------------------- the dense variants' kernel shapes

@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("dtype,tol,b,p,s,h,hk,dh,window", [
    (torch.bfloat16, 2e-2, 2, 0, 130, 32, 8, 80, 0),      # h2o-danube-1.8b, dh 80
    (torch.bfloat16, 2e-2, 2, 20, 150, 32, 8, 80, 64),    # ... inside a window
    (torch.bfloat16, 2e-2, 2, 45, 64, 56, 8, 128, 0),     # deepseek-coder-33b, G 7
    (torch.bfloat16, 2e-2, 2, 0, 70, 96, 8, 192, 0),      # nemotron-4-340b, G 12, dh 192
    (torch.bfloat16, 2e-2, 1, 9, 40, 16, 2, 128, 0),      # qwen2.5-3b, G 8
    (torch.float32, 1e-5, 3, 9, 40, 4, 2, 32, 0),         # qwen2.5-3b smoke, fp32 dh 32
    (torch.float32, 1e-5, 2, 0, 50, 4, 2, 32, 12),
    (torch.float32, 1e-5, 2, 5, 40, 8, 2, 24, 0),         # nemotron-4-340b smoke, dh 24
    (torch.bfloat16, 2e-2, 2, 0, 128, 64, 4, 128, 0),     # qwen3-moe-235b-a22b, G 16
    (torch.bfloat16, 2e-2, 1, 45, 64, 64, 4, 128, 0),
    (torch.bfloat16, 2e-2, 2, 0, 128, 16, 1, 256, 0),     # recurrentgemma-9b, G 16, dh 256
    (torch.bfloat16, 2e-2, 1, 0, 300, 16, 1, 256, 64),    # ... inside a window
    (torch.bfloat16, 2e-2, 2, 45, 70, 16, 1, 256, 0),     # ... over a prefix
])
def test_flash_new_head_dims_and_groups_match_plain(impl, dtype, tol, b, p, s, h, hk, dh,
                                                    window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(p + s + dh)
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, p + s, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, p + s, hk, dh, device=dev, generator=g).to(dtype)
    q_pos = torch.arange(p, p + s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    k_pos = torch.arange(p + s, device=dev, dtype=torch.int32).expand(b, p + s).contiguous()
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                                    block_q=64, block_k=64, impl=impl)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    f = [x.float() for x in (q, k, v)]
    want = (attend_naive(*f, q_pos, k_pos, True, window) if impl == "naive" else
            attend_blockwise(*f, q_pos, k_pos, True, window, 64, 64))
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol,b,h,hk,t,dh", [
    (torch.bfloat16, 2e-2, 4, 32, 8, 300, 80),      # h2o-danube-1.8b
    (torch.bfloat16, 2e-2, 2, 32, 8, 4096, 80),     # its whole ring
    (torch.bfloat16, 2e-2, 4, 56, 8, 160, 128),     # deepseek-coder-33b, G 7
    (torch.bfloat16, 2e-2, 4, 96, 8, 160, 192),     # nemotron-4-340b, G 12
    (torch.bfloat16, 2e-2, 4, 64, 4, 161, 128),     # qwen3-moe-235b-a22b, G 16
    (torch.bfloat16, 2e-2, 8, 64, 4, 700, 128),     # G 16, more rows, splits merged
    (torch.float32, 1e-5, 8, 8, 4, 300, 16),        # serve-tiny's big model, dh 16
    (torch.float32, 1e-5, 3, 4, 2, 45, 16),         # its small model, one split
    (torch.float32, 1e-5, 2, 8, 1, 700, 16),        # G 8, splits merged
    (torch.bfloat16, 2e-2, 4, 16, 1, 2048, 256),    # recurrentgemma-9b's ring, G 16
    (torch.bfloat16, 2e-2, 3, 16, 1, 300, 256),     # ... fewer splits
    (torch.bfloat16, 2e-2, 32, 16, 1, 2048, 256),   # 32 rows: the one-a-SM wave cut
    (torch.float32, 1e-5, 3, 4, 1, 45, 32),         # recurrentgemma-9b smoke, fp32 dh 32
])
def test_decode_new_shapes_match_plain(dtype, tol, b, h, hk, t, dh):
    """Ragged lengths, a full row and a row at cache_len 0 (the uniform
    rule) against the plain version, one launch a call."""
    dev = _cuda()
    q, k, v = _dense_case(dev, t + dh, b, 0, h, hk, t, dh, dtype)
    g = torch.Generator(device=dev).manual_seed(t)
    lens = torch.randint(1, t + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0], lens[-1] = t, 0
    before = dec_ops.launches
    out, ref = _dense_both(q, k, v, lens, 0)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("b,h,hk,t,dh", [(4, 32, 8, 160, 80), (4, 56, 8, 160, 128),
                                         (4, 96, 8, 206, 192), (2, 96, 8, 700, 192),
                                         (4, 64, 4, 161, 128), (8, 64, 4, 300, 128)])
def test_verify_and_paged_new_shapes_match_plain(kq, b, h, hk, t, dh):
    """The dense verify block and both paged kernels at dh 80 and 192 and G
    7, 12 and 16 (bf16: the panel body only), against the plain versions."""
    dev = _cuda()
    q, k, v = _dense_case(dev, t + kq, b, kq, h, hk, t, dh, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(t + kq)
    lens = torch.randint(0, t - kq + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t - kq
    out, ref = _dense_both(q, k, v, lens, kq)
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    q, kp, vp, tbl, sp, qpos = _paged_case(dev, g, b, kq, h, hk, dh, 16, t, torch.bfloat16)
    f = [x.float() for x in (q, kp, vp)]
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    ref = paged_decode_attention_block_ref(f[0], f[1], f[2], tbl, sp, qpos)
    torch.testing.assert_close(out[:-1].float(), ref[:-1], rtol=2e-2, atol=2e-2)
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    ref1 = paged_decode_attention_ref(f[0][:, 0], f[1], f[2], tbl, sp)
    torch.testing.assert_close(one[:-1].float(), ref1[:-1], rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol,b,sq,sk,h,hk,dh,impl", [
    (torch.bfloat16, 2e-2, 4, 1500, 1500, 6, 6, 64, "naive"),    # whisper-tiny's encoder
    (torch.bfloat16, 2e-2, 4, 128, 1500, 6, 6, 64, "naive"),     # its cross prefill
    (torch.bfloat16, 2e-2, 2, 1500, 1500, 6, 6, 64, "xla_flash"),  # padded keys admitted
    (torch.float32, 1e-5, 4, 16, 16, 4, 4, 32, "naive"),         # whisper smoke, fp32 dh 32
    (torch.float32, 1e-5, 4, 64, 16, 4, 4, 32, "naive"),         # ... its cross attention
])
def test_flash_non_causal_new_shapes_match_plain(dtype, tol, b, sq, sk, h, hk, dh, impl):
    """Non-causal flash at whisper's shapes: the bidirectional encoder over
    1,500 frames and the cross attention (positions all 0) over them,
    against the plain versions; under "xla_flash" the zero keys padding Sk
    to a whole block take weight, as in the reference."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(sq + sk + dh)
    q = torch.randn(b, sq, h, dh, device=dev, generator=g).to(dtype)
    k = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    v = torch.randn(b, sk, hk, dh, device=dev, generator=g).to(dtype)
    if sq == sk:
        q_pos = torch.arange(sq, device=dev, dtype=torch.int32).expand(b, sq).contiguous()
        k_pos = q_pos
    else:
        q_pos = torch.zeros(b, sq, device=dev, dtype=torch.int32)
        k_pos = torch.zeros(b, sk, device=dev, dtype=torch.int32)
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=False, window=0,
                                    block_q=128, block_k=128, impl=impl)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    f = [x.float() for x in (q, k, v)]
    want = (attend_naive(*f, q_pos, k_pos, False, 0) if impl == "naive" else
            attend_blockwise(*f, q_pos, k_pos, False, 0, 128, 128))
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    # the padded form is another function: its zero keys shift every output by
    # ~1.4% at Sk 1,500, within ``tol``, so the kernel must also lie nearer its
    # own form than the other, by less than half the L2 gap between the two
    other = (attend_blockwise(*f, q_pos, k_pos, False, 0, 128, 128) if impl == "naive" else
             attend_naive(*f, q_pos, k_pos, False, 0))
    assert _l2(out.float() - want) < 0.5 * _l2(want - other)


def _l2(x) -> float:
    return torch.linalg.vector_norm(x).item()


@pytest.mark.parametrize("dtype,tol,b,lens", [
    (torch.bfloat16, 2e-2, 4, (1500, 1500, 1500, 1500)),    # whisper's cross decode
    (torch.bfloat16, 2e-2, 4, (1500, 700, 1, 0)),           # ragged, a row at 0
    (torch.float32, 1e-5, 4, (16, 16, 16, 16)),             # whisper smoke, fp32 dh 32
])
def test_decode_over_a_1500_slot_cross_cache_matches_plain(dtype, tol, b, lens):
    """The dense decode kernel as whisper's cross attention runs it: every
    slot of the encoder's 1,500 (or the smoke config's 16) kept, H 6 / 6 at
    dh 64 (4 / 4 at dh 32 in fp32), one launch a call."""
    dev = _cuda()
    h, dh, t = (6, 64, 1500) if dtype == torch.bfloat16 else (4, 32, 16)
    q, k, v = _dense_case(dev, t, b, 0, h, h, t, dh, dtype)
    lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    before = dec_ops.launches
    out, ref = _dense_both(q, k, v, lens, 0)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    if bool((lens == t).all()):   # no row masks the last tile but the bound T itself
        pad = dec_ops.TILE - t % dec_ops.TILE
        kp, vp = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (k, v))
        other = decode_attention_ref(q.float(), kp, vp, lens + pad)
        assert _l2(out.float() - ref) < 0.5 * _l2(ref - other)


@pytest.mark.parametrize("dh", [64, 80, 128, 192])
@pytest.mark.parametrize("kq", [1, 4])
def test_panel_kernels_at_g6_match_plain(kq, dh):
    """internvl2-26b's G 6 (48 heads on 8) in the four panel kernels: the
    dense single-token decode and verify block, both paged kernels (a K-4
    block takes two queries a panel), against the plain versions."""
    dev = _cuda()
    b, h, hk, t = 4, 48, 8, 417
    q, k, v = _dense_case(dev, t + kq + dh, b, kq, h, hk, t, dh, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(t + kq + dh)
    lens = torch.randint(0, t - kq + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0] = t - kq
    out, ref = _dense_both(q, k, v, lens, kq)
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    if kq == 1:
        out, ref = _dense_both(q[:, 0].contiguous(), k, v, lens + 1, 0)
        torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
        plan = dec_ops.launch_plan(b, 4, t, hk, h // hk, dh, torch.bfloat16)
        assert plan.kq_panel == 2 and plan.grid[2] == 2
    q, kp, vp, tbl, sp, qpos = _paged_case(dev, g, b, kq, h, hk, dh, 16, t, torch.bfloat16)
    f = [x.float() for x in (q, kp, vp)]
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    ref = paged_decode_attention_block_ref(f[0], f[1], f[2], tbl, sp, qpos)
    torch.testing.assert_close(out[:-1].float(), ref[:-1], rtol=2e-2, atol=2e-2)
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    ref1 = paged_decode_attention_ref(f[0][:, 0], f[1], f[2], tbl, sp)
    torch.testing.assert_close(one[:-1].float(), ref1[:-1], rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-26b"])
def test_frontend_smoke_stacks_on_the_card_match_the_cpu(arch):
    """whisper-tiny's and internvl2-26b's smoke stacks (fp32) on the card
    against the CPU: prefill with frames or prefix embeddings, 12 decode
    steps; whisper's cross decode through the dense decode kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    dev = _cuda()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(5, cfg.vocab_size, (2, 20), generator=gen)
    steps = torch.randint(5, cfg.vocab_size, (12, 2), generator=gen)
    extra = ({"frames": torch.randn(2, cfg.enc_frames, cfg.d_model, generator=gen)}
             if model.is_encdec else
             {"prefix_embeds": torch.randn(2, cfg.num_prefix_tokens, cfg.frontend_dim,
                                           generator=gen)})
    runs = []
    for device in (torch.device("cpu"), dev):
        p = _to(params, device)
        reset_launch_counts()
        batch = {"tokens": toks.to(device), **{k: x.to(device) for k, x in extra.items()}}
        out, caches = model.prefill(p, batch, 20 + 12 + cfg.num_prefix_tokens)
        seq = [out]
        for tok in steps:
            out, caches = model.decode_step(p, tok.to(device), caches)
            seq.append(out)
        runs.append(torch.stack(seq).cpu())
        if device.type == "cuda":
            pre, step = (encdec.attention_calls(cfg) if model.is_encdec else
                         (cfg.num_layers, cfg.num_layers))
            counts = launch_counts()
            assert counts["flash_attention"] == pre and counts["decode_attention"] == 12 * step
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-26b"])
def test_train_cli_frontend_archs_on_the_card(arch, capsys):
    """The train CLI's smoke run of whisper-tiny (fp32 flash at dh 32:
    encoder, decoder and cross attention) and internvl2-26b (dh 16, G 4,
    over 8 prefix positions): the loss falls, the flash launches a step are
    the forward's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import encdec
    _cuda()
    cfg = get_config(arch, smoke=True)
    before = flash_ops.launches
    rc = train.main(["--steps", "20", "--arch", arch])
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    per_step = encdec.attention_calls(cfg)[0] if cfg.enc_layers else cfg.num_layers
    assert flash_ops.launches - before == 20 * per_step


def test_danube_smoke_stack_on_the_card_matches_the_cpu():
    """h2o-danube-1.8b's smoke stack (fp32, dh 16, window 16) on the card
    against the CPU: a 24-token prompt laid out in the 16-slot ring, then 20
    decode steps that wrap it, through the flash and dense decode kernels."""
    from repro_torch.configs import get_config
    dev = _cuda()
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(5, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    steps = torch.randint(5, cfg.vocab_size, (20, 2), generator=torch.Generator().manual_seed(2))
    logits = {}
    for device in (torch.device("cpu"), dev):
        p = _to(params, device)
        reset_launch_counts()
        out, caches = model.prefill(p, {"tokens": toks.to(device)}, 24 + 20)
        assert caches["scan"][0]["k"].shape[2] == cfg.sliding_window
        seq = [out]
        for tok in steps:
            out, caches = model.decode_step(p, tok.to(device), caches)
            seq.append(out)
        logits[device.type] = torch.stack(seq).cpu()
        if device.type == "cuda":
            counts = launch_counts()
            assert counts["flash_attention"] == cfg.num_layers
            assert counts["decode_attention"] == 20 * cfg.num_layers
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-coder-33b", "h2o-danube-1.8b",
                                  "nemotron-4-340b", "arctic-480b", "qwen3-moe-235b-a22b",
                                  "mamba2-130m", "recurrentgemma-9b"])
def test_train_cli_each_arch_on_the_card(arch, capsys):
    """The train CLI's smoke run of each dense variant, MoE stack and
    recurrent stack on the card (fp32 flash at dh 32, 16, 16, 24, 16, 16,
    none and 32): the loss falls, one flash launch an attention layer a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    _cuda()
    before = flash_ops.launches
    rc = train.main(["--steps", "20", "--arch", arch])
    out = capsys.readouterr().out
    assert rc == 0 and "(improved)" in out, out
    assert flash_ops.launches - before == 20 * attention_layers(get_config(arch, smoke=True))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_recurrent_smoke_stack_on_the_card_matches_the_cpu(arch):
    """The recurrent smoke stacks (fp32) on the card against the CPU: a
    24-token prompt (past recurrentgemma's 16-slot ring) and 12 decode
    steps, the SSM / RG-LRU states and the local attention's KV updated in
    place; recurrentgemma's one attention layer through the flash kernel
    and the dense decode kernel (fp32, dh 32, G 4)."""
    from repro_torch.configs import get_config
    dev = _cuda()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(5, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    steps = torch.randint(5, cfg.vocab_size, (12, 2), generator=torch.Generator().manual_seed(2))
    runs = []
    for device in (torch.device("cpu"), dev):
        p = _to(params, device)
        reset_launch_counts()
        out, caches = model.prefill(p, {"tokens": toks.to(device)}, 24 + 12)
        seq = [out]
        for tok in steps:
            out, caches = model.decode_step(p, tok.to(device), caches)
            seq.append(out)
        runs.append((torch.stack(seq).cpu(), [t.cpu() for c in caches["scan"] + caches["rem"]
                                              for t in c.values()]))
        if device.type == "cuda":
            counts, n = launch_counts(), attention_layers(cfg)
            assert counts["flash_attention"] == n and counts["decode_attention"] == 12 * n
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-4)
    for got, want in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dh256_is_refused_by_the_verify_and_paged_kernels():
    """Only the dense single-token kernel has a dh-256 instance: recurrent
    and windowed stacks neither speculate nor page."""
    dev = _cuda()
    q, k, v = _dense_case(dev, 3, 2, 2, 16, 1, 128, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported shapes"):
        dec_ops.decode_attention_block(q, k, v, torch.full((2,), 64, device=dev,
                                                           dtype=torch.int32))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_smoke_stack_on_the_card_matches_the_cpu(arch):
    """The MoE smoke stacks (fp32, dh 16) on the card against the CPU:
    ``apply_moe`` alone on a group that drops pairs (the same kept set),
    then a prefill of 4 x 24 tokens and 8 decode steps through the flash
    and dense decode kernels, and the training forward's aux."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    dev = _cuda()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    layer = params["layers"][0]["moe"]
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    tight = cfg.replace(capacity_factor=1.0)
    runs = []                                   # (out, aux, kept) on the CPU, then the card
    for device in (torch.device("cpu"), dev):
        p = _to(layer, device)
        out, aux = moe.apply_moe(p, x.to(device), tight)
        _, _, _, rank, cap, _ = moe.route(p, x.to(device), tight)
        runs.append((out.cpu(), aux.cpu(), (rank < cap).cpu()))
    (out0, aux0, kept0), (out1, aux1, kept1) = runs
    assert torch.equal(kept1, kept0) and not bool(kept0.all())
    torch.testing.assert_close(out1, out0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux1, aux0, rtol=1e-5, atol=1e-6)
    toks = torch.randint(5, cfg.vocab_size, (4, 24), generator=torch.Generator().manual_seed(2))
    steps = torch.randint(5, cfg.vocab_size, (8, 4), generator=torch.Generator().manual_seed(3))
    runs = []                                   # (logits of every step, aux)
    for device in (torch.device("cpu"), dev):
        p = _to(params, device)
        reset_launch_counts()
        out, caches = model.prefill(p, {"tokens": toks.to(device)}, 24 + 8)
        seq = [out]
        for tok in steps:
            out, caches = model.decode_step(p, tok.to(device), caches)
            seq.append(out)
        runs.append((torch.stack(seq).cpu(),
                     model.forward(p, {"tokens": toks.to(device)})[1].cpu()))
        if device.type == "cuda":
            counts = launch_counts()
            assert counts["flash_attention"] == 2 * cfg.num_layers
            assert counts["decode_attention"] == 8 * cfg.num_layers
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-5, atol=1e-6)


def test_serve_cli_default_stack_on_the_card(capsys):
    """The serve CLI with its defaults (the tiny fp32 stack, dh 16, on the
    card), fewer queries: every request completes."""
    from repro_torch.launch import serve
    _cuda()
    reset_launch_counts()
    assert serve.main(["--queries", "24"]) == 0
    out = capsys.readouterr().out
    assert "requests: 24 " in out and "on cuda" in out, out
    assert launch_counts()["decode_attention"] > 0


def _scrambled_case(dev, kq, g, page, dtype, seed, dh=128):
    """Rows whose valid slots hold a permutation of positions [0, n) (so a
    slot's position is not its index), with rewound holes, a 64-slot tile
    [64, 128) empty in the middle of the row, and row 0 with no valid slot.
    Table entries of pages with no valid slot are out of range: a read of
    them faults.  Returns the inputs and the table the plain version takes
    (those entries on the TRASH page)."""
    rng = np.random.default_rng(seed)
    b, hk, cap = 4, 2, 300
    npg = -(-cap // page)
    pages = b * npg
    sp = np.full((b, cap), -1, np.int32)
    for row in range(1, b):
        slots = np.setdiff1d(np.arange(cap - int(rng.integers(0, 40))), np.arange(64, 128))
        slots = slots[rng.random(slots.size) > 0.15]                # rewound holes
        sp[row, slots] = rng.permutation(slots.size)
    tbl = rng.permutation(pages).reshape(b, npg).astype(np.int32)
    empty = (np.pad(sp, ((0, 0), (0, npg * page - cap)), constant_values=-1)
             .reshape(b, npg, page) < 0).all(-1)
    ref_tbl = np.where(empty, pages, tbl).astype(np.int32)
    tbl = np.where(empty, 1 << 28, tbl).astype(np.int32)
    qpos = np.maximum((sp.max(1) + 1) - kq, 0).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, kq, hk * g, dh), dtype=np.float32))
    kp = torch.from_numpy(rng.standard_normal((pages + 1, page, hk, dh), dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((pages + 1, page, hk, dh), dtype=np.float32))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype), t(tbl), t(sp), t(qpos),
            t(ref_tbl))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("kq", [1, 2, 3, 4])
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_paged_kernels_follow_positions_not_slots(dtype, tol, kq, page, g):
    """Masks come from slot_pos per slot and query, never from the slot
    index; a page with no valid slot is never read (its table entry is out
    of range); an empty tile mid-row, cap 300 (not a multiple of 64) and
    page 32; a row with no valid slot gives exactly 0."""
    dev = _cuda()
    q, kp, vp, tbl, sp, qpos, ref_tbl = _scrambled_case(dev, kq, g, page, dtype, kq + 7 * g)
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, kp, vp)]
    ref = paged_decode_attention_block_ref(f[0], f[1], f[2], ref_tbl, sp, qpos)
    torch.testing.assert_close(out[1:].float(), ref[1:], rtol=tol, atol=tol)
    assert not out[0].float().abs().max()
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    torch.cuda.synchronize()
    ref1 = paged_decode_attention_ref(f[0][:, 0], f[1], f[2], ref_tbl, sp)
    torch.testing.assert_close(one[1:].float(), ref1[1:], rtol=tol, atol=tol)
    assert not one[0].float().abs().max()


@pytest.mark.parametrize("kq", [1, 4])
def test_paged_cluster_merge_repeats_bit_for_bit(kq):
    """bf16 at the main shapes, whose splits merge inside their thread-block
    cluster: the rows match the plain version, and bit for bit from one call
    to the next."""
    dev = _cuda()
    g_ = torch.Generator(device=dev).manual_seed(kq)
    q, kp, vp, tbl, sp, qpos = _paged_case(dev, g_, 8, kq, 32, 8, 128, 16, 206, torch.bfloat16)
    assert dec_ops.launch_plan(8, kq, 206, 8, 4, 128, torch.bfloat16).splits > 1
    f = [x.float() for x in (q, kp, vp)]
    ref = paged_decode_attention_block_ref(f[0], f[1], f[2], tbl, sp, qpos)
    outs = [paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos) for _ in range(3)]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][:-1].float(), ref[:-1], rtol=2e-2, atol=2e-2)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("b,n,d,p_valid,block_n", [(8, 8192, 384, 0.9, 1024),
                                                   (3, 5000, 64, 0.0005, 512),
                                                   (20, 4096, 128, 1.0, 1024)])
def test_cosine_kernel_matches_plain(b, n, d, p_valid, block_n):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n)
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=g), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=g), dim=-1)
    valid = torch.rand(n, device=dev, generator=g) < p_valid
    db[n // 2] = db[1]                                  # a tie: the lower index first
    s, i = cos_ops.cosine_topk(q, db, valid, k=4, block_n=block_n)
    s_ref, i_ref = cosine_topk_ref(q, db, 4, valid)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)
    fin = torch.isfinite(s_ref)
    assert torch.equal(torch.isfinite(s), fin)
    gap = torch.full_like(s_ref, float("inf"))
    d_ = torch.diff(torch.where(fin, s_ref, 1e9), dim=1).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
    sure = fin & (gap > 1e-5)
    assert torch.equal(i[sure], i_ref[sure])
    assert bool((i[~fin] == -1).all())
    q2 = torch.stack([db[1], db[n // 2]])
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    _, i2 = cos_ops.cosine_topk(q2.contiguous(), db, ones, k=2, block_n=block_n)
    assert i2[:, :2].tolist() == [[1, n // 2], [1, n // 2]]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_cosine_kernel_k_ragged_empty_block_and_cross_block_tie(k):
    """N not a multiple of block_n (nor of the 256-row stage), a block with
    no valid row, and an exact tie whose rows lie in different blocks: the
    lower index wins."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(k)
    b, n, d, block_n = 8, 10_000, 384, 1024
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=g), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=g), dim=-1)
    valid = torch.rand(n, device=dev, generator=g) < 0.9
    valid[2 * block_n:3 * block_n] = False               # block 2 has no valid row
    db[300] = q[0]                                       # block 0 ...
    db[5000] = q[0]                                      # ... and block 4 tie at 1.0
    valid[300] = valid[5000] = True
    before = cos_ops.launches
    s, i = cos_ops.cosine_topk(q, db, valid, k=k, block_n=block_n)
    torch.cuda.synchronize()
    assert cos_ops.launches == before + 1
    s_ref, i_ref = cosine_topk_ref(q, db, k, valid)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)
    gap = torch.full_like(s_ref, float("inf"))
    d_ = torch.diff(s_ref, dim=1).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
    sure = gap > 1e-5
    assert torch.equal(i[sure], i_ref[sure])
    assert i[0, :min(k, 2)].tolist() == [300, 5000][:min(k, 2)]
    assert not bool(((i >= 2 * block_n) & (i < 3 * block_n)).any())


@pytest.mark.parametrize("k", [2, 8])
def test_cosine_kernel_tie_between_lanes_of_one_warp(k):
    """Exact ties between rows that two lanes of one warp score (a stage is
    128 rows, one a thread, so row r sits in lane (r % 128) % 32 of warp
    (r % 128) // 32): the lower index wins whether it is in the lower lane
    (rows 165, 172: lanes 5, 12) or the higher one (rows 300, 421: lanes 12,
    5)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(k)
    b, n, d, block_n = 8, 10_000, 384, 1024
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=g), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=g), dim=-1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    db[300] = db[421] = q[0]
    db[165] = db[172] = q[1]
    s, i = cos_ops.cosine_topk(q, db, valid, k=k, block_n=block_n)
    s_ref, i_ref = cosine_topk_ref(q, db, k, valid)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)
    assert i[0, :2].tolist() == [300, 421] and i[1, :2].tolist() == [165, 172]
    assert s[0, 0].item() == s[0, 1].item() and s[1, 0].item() == s[1, 1].item()
    assert torch.equal(i[:2], i_ref[:2])


@pytest.mark.parametrize("b,n,m,d,k,block_m,p_live,corners", [
    (8, 65536, 2048, 384, 4, 64, 0.5, "near"),     # the IVF probe at the main path's widths
    (3, 5000, 200, 64, 8, 64, 0.7, "near"),        # M not a multiple of the block
    (5, 1000, 96, 128, 1, 32, 0.02, "near"),       # fewer live candidates than k
    (8, 65536, 2048, 384, 8, 64, 0.5, "near"),     # k 8 at the main path's widths
    (4, 3000, 40, 384, 4, 64, 0.8, "near"),        # M smaller than one block
    (3, 5000, 203, 384, 4, 64, 0.6, "near"),       # M not a multiple of 4: scalar loads
    (8, 65536, 8192, 384, 4, 64, 0.5, "far"),      # tie and repeat in different blocks
    (4, 5000, 2048, 384, 4, 64, 0.5, "beyond"),    # indices >= N marked valid
    (4, 5000, 2048, 384, 4, 64, 0.5, "dead"),      # every candidate dead
])
def test_gather_kernel_matches_plain(b, n, m, d, k, block_m, p_live, corners):
    """The shortlist kernel against its plain version: padding (-1), rows
    listed twice, a tie whose lower position must win, a query with no live
    candidate.  ``corners`` "far" puts the tie and the repeat in different
    blocks of the query's cluster, "beyond" marks indices past the bank
    valid (they stay dead), "dead" leaves no live candidate at all."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m)
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=g), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=g), dim=-1)
    idx = torch.randint(0, n, (b, m), device=dev, generator=g, dtype=torch.int32)
    idx[torch.rand(b, m, device=dev, generator=g) < 0.1] = -1
    valid = torch.rand(b, m, device=dev, generator=g) < p_live
    if corners == "beyond":
        past = torch.rand(b, m, device=dev, generator=g) < 0.2
        idx[past] = n + torch.arange(m, device=dev, dtype=torch.int32).expand(b, m)[past] % 5
        valid |= past
    pos = [0, 1, 2]
    if corners == "far":
        blocks = cos_ops.gather_plan(b, m, d, k, block_m).blocks
        assert len(blocks) >= 3
        pos = [blocks[0][1] - 1, blocks[1][0], blocks[-1][1] - 1]
    db[7] = q[0]                                      # rows 7 and 3 tie at score 1 ...
    db[3] = q[0]
    idx[0, 3] = -1                                    # ... 7 first; 3 twice; padding
    idx[0, pos] = torch.tensor([7, 3, 3], dtype=torch.int32, device=dev)
    valid[0, pos + [3]] = True
    valid[-1] = False                                 # no live candidate
    if corners == "dead":
        valid[:] = False
    s, i = cos_ops.cosine_topk_gather(q, db, idx, valid, k=k, block_m=block_m)
    live = valid & (idx >= 0) & (idx < n)
    s_ref, i_ref = cosine_topk_gather_ref(q, db[idx.clamp(0, n - 1).long()], idx, live, k)
    fin = torch.isfinite(s_ref)
    assert torch.equal(torch.isfinite(s), fin)
    torch.testing.assert_close(s[fin], s_ref[fin], rtol=1e-5, atol=1e-5)
    gap = torch.full_like(s_ref, float("inf"))
    d_ = torch.diff(torch.where(fin, s_ref, 1e9), dim=1).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d_)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d_)
    sure = fin & (gap > 1e-5)
    assert torch.equal(i[sure], i_ref[sure])
    assert bool((i[~fin] == -1).all()) and bool((i[-1] == -1).all())
    if corners == "dead":
        assert bool((i == -1).all()) and bool(torch.isneginf(s).all())
        return
    assert i[0, :min(k, 3)].tolist() == [7, 3, 3][:min(k, 3)]
    assert len(set(s[0, :min(k, 3)].tolist())) == 1   # the same row scores the same bits


def test_gather_kernel_launches_once_and_allocates_only_the_output():
    """At the main shape: one kernel launch per call (the blocks of a query
    merge in their cluster, no second launch) and two allocations, the
    outputs (no scratch)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    b, n, m, d = 8, 65536, 2048, 384
    q = torch.nn.functional.normalize(torch.randn(b, d, device=dev, generator=g), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(n, d, device=dev, generator=g), dim=-1)
    idx = torch.randint(0, n, (b, m), device=dev, generator=g, dtype=torch.int32)
    valid = torch.rand(b, m, device=dev, generator=g) < 0.5
    cos_ops.cosine_topk_gather(q, db, idx, valid, k=4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    launches = cos_ops.gather_launches
    cos_ops.cosine_topk_gather(q, db, idx, valid, k=4)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == before + 2
    assert cos_ops.gather_launches == launches + 1
    torch.cuda.synchronize()
    kernels = _profiled_kernels(lambda: cos_ops.cosine_topk_gather(q, db, idx, valid, k=4), 3)
    assert len(kernels) == 1 and kernels[0][1] == 3, kernels
    assert "gather_topk_kernel" in kernels[0][0], kernels


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _small_engine(device, vocab=2048, **cache_kw):
    """serve-tiny widened to head dim 64 (the kernels take 64 or 128), with
    weights drawn on the CPU and moved to ``device``."""
    big_cfg, small_cfg, ecfg, _ = model_configs("serve-tiny", vocab)
    gen_cfg = GenerateConfig(sampler=SamplerConfig(vocab_size=vocab))
    gens = []
    for seed, cfg in enumerate((big_cfg, small_cfg), start=1):
        model = build_model(cfg.replace(d_model=256, num_heads=4, num_kv_heads=2))
        params = model.init(torch.Generator().manual_seed(seed), "cpu")
        gens.append(Generator(model, _to(params, device), gen_cfg))
    eparams = init_embedder(ecfg, torch.Generator().manual_seed(0), "cpu")
    return TweakLLMEngine(tokenizer=HashWordTokenizer(vocab),
                          embedder_params=_to(eparams, device), embedder_cfg=ecfg,
                          big=gens[0], small=gens[1],
                          cache_cfg=CacheConfig(capacity=256, dim=ecfg.d_model, **cache_kw),
                          router_cfg=RouterConfig(tweak_threshold=0.9))


def test_engine_on_the_card_matches_the_cpu():
    """The same small fp32 stack served on the card and on the CPU: same
    routes and responses, and every kernel launched on the card."""
    dev = _cuda()
    pairs = (["how do i learn rust setup", "why is keto diet good"],
             ["practice daily", "it helps"])
    batch = ["how do i learn rust setup", "how do i learn rust setup please",
             "what is the price of solar panels", "why is keto diet good please"]
    out = {}
    for device in (torch.device("cpu"), dev):
        eng = _small_engine(device)
        eng.populate(*pairs)
        reset_launch_counts()
        out[device.type] = eng.handle_batch(batch, max_new_tokens=6, collect_meta=True)
        counts = launch_counts()
        if device.type == "cuda":
            assert min(counts[k] for k in DENSE_PATH) > 0
        else:
            assert max(counts.values()) == 0
    (r_cpu, m_cpu), (r_gpu, m_gpu) = out["cpu"], out["cuda"]
    assert [m["decision"] for m in m_gpu] == [m["decision"] for m in m_cpu]
    assert {m["decision"] for m in m_gpu} >= {router.EXACT, router.MISS}
    np.testing.assert_allclose([m["sim"] for m in m_gpu], [m["sim"] for m in m_cpu],
                               atol=1e-5)
    assert r_gpu == r_cpu


def test_ivf_engine_on_the_card_matches_the_cpu():
    """The same stack with an IVF bank (4 clusters, 2 probed) whose table was
    rebuilt once on the CPU and handed to both engines: same routes,
    responses and member table on the card as on the CPU after a batch whose
    misses are filed on the device; the lookup goes through the shortlist
    kernel, never the flat one."""
    from repro_torch.core import index as index_lib
    dev = _cuda()
    pairs = (["how do i learn rust setup", "why is keto diet good", "what is origami",
              "how to bake sourdough bread", "best way to learn piano", "what is a black hole"],
             ["practice daily", "it helps", "paper folding", "slowly", "scales", "gravity"])
    batch = ["how do i learn rust setup", "how do i learn rust setup please",
             "what is the price of solar panels", "why is keto diet good please",
             "tell me about the history of rome"]
    base = _small_engine(torch.device("cpu"), index="ivf", nclusters=4, nprobe=2)
    base.populate(*pairs)
    index_lib.build_index(base.state, base.cache_cfg, seed=0)
    out = {}
    for device in (torch.device("cpu"), dev):
        eng = _small_engine(device, index="ivf", nclusters=4, nprobe=2)
        eng.bank.state = {k: v.clone().to(device) for k, v in base.state.items()}
        eng.bank.text_store.update(base.bank.text_store)
        reset_launch_counts()
        out[device.type] = (eng.handle_batch(batch, max_new_tokens=6, collect_meta=True),
                            launch_counts(), {k: v.cpu() for k, v in eng.state.items()})
        per_slot = index_lib.live_entries_per_slot(eng.state)
        assert torch.equal(per_slot, eng.state["valid"].long())
    (r_cpu, m_cpu), c_cpu, st_cpu = out["cpu"]
    (r_gpu, m_gpu), c_gpu, st_gpu = out["cuda"]
    assert c_gpu["cosine_topk_gather"] > 0 and c_gpu["cosine_topk"] == 0
    assert max(c_cpu.values()) == 0
    assert [m["decision"] for m in m_gpu] == [m["decision"] for m in m_cpu]
    assert router.MISS in [m["decision"] for m in m_gpu]
    np.testing.assert_allclose([m["sim"] for m in m_gpu], [m["sim"] for m in m_cpu],
                               atol=1e-5)
    assert r_gpu == r_cpu
    for key in ("ivf_members", "ivf_count", "ivf_assign", "ivf_pos", "ivf_pending",
                "adm_count", "valid"):
        assert torch.equal(st_gpu[key], st_cpu[key]), key
    torch.testing.assert_close(st_gpu["adm_ema"], st_cpu["adm_ema"], rtol=0, atol=1e-6)


def _ids(text):
    """Token ids of a generated response (the tokenizer renders id i as wi)."""
    return [int(w[1:]) for w in text.split() if w[1:].isdigit()]


def test_paged_spec_engine_on_the_card_matches_the_cpu():
    """Paged generators and a speculating small one (spec_k 4), drafts set in
    the bank from a first pass: same routes, responses and speculation
    counters on the card as on the CPU, through the paged and q-block
    kernels, with no page leaked."""
    from repro_torch.serving.continuous import leaked_pages
    dev = _cuda()
    pairs = (["how do i learn rust setup", "why is keto diet good"],
             ["practice daily", "it helps"])
    batch = ["how do i learn rust setup please", "what is the price of solar panels",
             "why is keto diet good please", "how do i learn rust setup"]
    out = {}
    for device in (torch.device("cpu"), dev):
        eng = _small_engine(device)
        for gen in (eng.big, eng.small):
            gen.cfg = dataclasses.replace(gen.cfg, paged=True, pool_pages=128,
                                          spec_k=4 if gen is eng.small else 1)
        eng.populate(*pairs)
        first = eng.handle_batch(batch, max_new_tokens=6, collect_meta=True)
        slot_of = {q: s_ for s_, (q, _) in eng.bank.text_store.items()}
        for i, m in enumerate(first[1]):
            if m["decision"] == router.TWEAK:
                src = preprocess_query(batch[i][:-len(" please")])
                eng.bank.draft_store[slot_of[src]] = _ids(first[0][i])
        reset_launch_counts()
        second = eng.handle_batch(batch, max_new_tokens=6, collect_meta=True)
        counts = launch_counts()
        st = eng.stats
        out[device.type] = (first, second, (st.proposed, st.accepted, st.spec_steps), counts)
        assert leaked_pages(eng.big, eng.small) == 0
    cpu, gpu = out["cpu"], out["cuda"]
    assert [m["decision"] for m in gpu[1][1]] == [m["decision"] for m in cpu[1][1]]
    assert gpu[0][0] == cpu[0][0] and gpu[1][0] == cpu[1][0]
    assert gpu[2] == cpu[2] and cpu[2][0] > 0
    assert gpu[3]["paged_decode_attention_block"] > 0
    assert max(cpu[3].values()) == 0


def test_sharded_lookup_on_the_card_matches_the_local_bank():
    """A 4-shard bank on one card (``make_cache_mesh`` naming cuda:0 four
    times) against the local bank, flat and at a full IVF probe: the same
    top-k (a tie straddling shards 0 and 3 goes to the lower slot), the
    cosine kernel once per shard, the shortlist kernel once per shard."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core import distributed as dist
    from repro_torch.core import index as index_lib
    from repro_torch.launch.mesh import make_cache_mesh
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    cfg = CacheConfig(capacity=4096, dim=384, topk=4, block_n=256)
    st = cache_lib.init_cache(cfg, dev)
    st["emb"].copy_(torch.nn.functional.normalize(
        torch.randn(4096, 384, device=dev, generator=g), dim=-1))
    st["valid"][:4000] = True
    q = torch.nn.functional.normalize(torch.randn(8, 384, device=dev, generator=g), dim=-1)
    st["emb"][[7, 3079]] = q[0]                       # shards 0 and 3 of 1,024 rows
    mesh = make_cache_mesh(4, devices=[dev] * 4)
    want = cache_lib.lookup(st, cfg, q)
    reset_launch_counts()
    got = dist.lookup(dist.shard_cache_state(st, mesh), cfg, q)
    assert launch_counts()["cosine_topk"] == 4
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    assert torch.equal(got[1], want[1]) and got[1][0, :2].tolist() == [7, 3079]
    icfg = dataclasses.replace(cfg, index="ivf", nclusters=16)
    ist = cache_lib.init_cache(icfg, dev)
    for key in ("emb", "valid"):
        ist[key].copy_(st[key])
    index_lib.build_index(ist, icfg, seed=0)
    full = dataclasses.replace(icfg, nprobe=16)
    reset_launch_counts()
    vs, vi = dist.lookup(dist.shard_ivf_cache_state(ist, mesh, full), full, q)
    counts = launch_counts()
    assert counts["cosine_topk_gather"] == 4 and counts["cosine_topk"] == 0
    torch.testing.assert_close(vs, want[0], rtol=0, atol=1e-5)
    assert torch.equal(vi, want[1])


def test_spec_session_verify_block_on_the_card_matches_the_cpu():
    """One ``DecodeSession(spec_k=4)`` on the card and on the CPU, fp32, drafts
    cut from the plain session's tokens (the second row's diverging after 3):
    the same tokens, lengths and ``spec_stats``, equal to the plain
    session's, through the paged verify kernel, no page leaked."""
    from repro_torch.serving.continuous import DecodeSession, leaked_pages
    dev = _cuda()
    prompts = np.random.default_rng(0).integers(5, 2048, (2, 8)).astype(np.int32)
    out = {}
    for device in (torch.device("cpu"), dev):
        gen = _small_engine(device).small
        gen.cfg = dataclasses.replace(gen.cfg, paged=True, max_new_tokens=12)
        plain = DecodeSession(gen, slots=2, capacity=32)
        plain.admit(prompts)
        ref = np.stack([f["tokens"] for f in sorted(plain.drain(), key=lambda f: f["slot"])])
        ids = ref.copy()
        ids[1, 3:] = (ids[1, 3:] + 1) % 2048
        sess = DecodeSession(gen, slots=2, capacity=32, spec_k=4)
        sess.admit(prompts, drafts=(ids, np.full(2, 12, np.int32)))
        reset_launch_counts()
        sess.run_chunk(12)
        counts = launch_counts()
        fins = sorted(sess.harvest(), key=lambda f: f["slot"])
        out[device.type] = (ref, np.stack([f["tokens"] for f in fins]), sess.spec_stats,
                            counts)
        assert leaked_pages(sess) == 0 and sess.pool.live_pages == 0
    cpu, gpu = out["cpu"], out["cuda"]
    assert np.array_equal(gpu[0], cpu[0]) and np.array_equal(gpu[1], cpu[1])
    assert np.array_equal(gpu[1], gpu[0])
    assert gpu[2] == cpu[2] and gpu[2]["accepted"] > 0
    assert gpu[3]["paged_decode_attention_block"] > 0 and max(cpu[3].values()) == 0


def test_sharded_bank_across_cards_matches_the_local_bank():
    """A bank row-sharded over every card of the machine (``make_cache_mesh``'s
    default: the first N CUDA devices) against a local bank on cuda:0, flat
    and IVF, through lookups, stage 2, FIFO commits and IVF rebuilds: the
    same routes, slots and final decisions, and the gathered state equal to
    the local one.  Needs two cards or more."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core import distributed as dist
    from repro_torch.core.engine import SharedCacheBank
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.models.reranker import init_reranker, tiny_reranker_config
    dev = _cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices (a multi-card machine)")
    mesh = make_cache_mesh(n)
    assert [d.index for d in mesh] == list(range(n))
    rr_cfg = tiny_reranker_config(512)
    reranker = (init_reranker(rr_cfg, torch.Generator(device=dev).manual_seed(3), dev), rr_cfg)
    rcfg = RouterConfig(tweak_threshold=0.85, band=0.2, admit_floor=0.3)
    g = torch.Generator(device=dev).manual_seed(1)
    centers = torch.nn.functional.normalize(torch.randn(6, 64, device=dev, generator=g), dim=-1)
    for index in ("flat", "ivf"):
        cfg = CacheConfig(capacity=256 * n, dim=64, max_query_tokens=8, max_response_tokens=8,
                          topk=4, block_n=64, index=index, nclusters=8, reindex_every=96)
        local = SharedCacheBank(cfg, rcfg, device=dev, reranker=reranker)
        sharded = SharedCacheBank(cfg, rcfg, mesh=mesh, reranker=reranker)
        rebuilt, stage2 = [], 0
        for step in range(8):
            q = centers[torch.randint(0, 6, (16,), device=dev, generator=g)]
            spread = torch.linspace(0.05, 0.6, 16, device=dev)[:, None] / 8   # 64 dims
            q = torch.nn.functional.normalize(
                q + spread * torch.randn(16, 64, device=dev, generator=g), dim=-1)
            qt = torch.randint(5, 512, (16, 8), device=dev, generator=g)
            qm = torch.ones(16, 8, device=dev)
            lo, sh = local.route_batch(q), sharded.route_batch(q)
            torch.testing.assert_close(sh[0], lo[0], rtol=0, atol=1e-5)
            for a, b in zip(lo[1:], sh[1:]):
                assert a.device == b.device and torch.equal(a, b)
            if bool((lo[2] == router.UNCERTAIN).any()):
                fl = local.second_stage(qt, qm, *lo[:5])
                fs = sharded.second_stage(qt, qm, *sh[:5])
                assert torch.equal(fl[0], fs[0]) and torch.equal(fl[1], fs[1])
                stage2 += 1
            rows = (q, qt.int(), qm, qt.int(), qm)
            assert torch.equal(local.insert_batch(*rows, 16), sharded.insert_batch(*rows, 16))
            rebuilt.append((local.maybe_reindex(), sharded.maybe_reindex()))
        assert all(a == b for a, b in rebuilt) and stage2 > 0
        assert any(a for a, _ in rebuilt) == (index == "ivf")
        got = dist.gather_cache_state(sharded.state, cfg)
        for key, val in local.state.items():
            if key not in ("ivf_members", "ivf_count", "ivf_pos"):
                torch.testing.assert_close(got[key], val, rtol=0, atol=1e-6, msg=key)
        slot = torch.tensor([3, 256 * n - 1], device=dev)
        assert torch.equal(cache_lib.gather_rows(sharded.state, "q_tokens", slot),
                           local.state["q_tokens"][slot])


# ------------------------------------------------- the assigned shapes (32k, 500k)

def _every_key_tol(want) -> float:
    """4 bf16 ulps of max |want|, at most 2e-2: a row over thousands of keys
    has |out| of a few thousandths, where 2e-2 would pass a wrong kernel."""
    top = want.abs().max().item()
    return min(2e-2, 4 * 2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else 2e-2


def test_flash_at_32k_matches_plain_on_row_slices():
    """The prefill kernel at prefill_32k's length (B 1, 32,768 causal
    positions, H 32 / 8, dh 128, "xla_flash" blocks of 128): the first and
    last 128 query rows over every key against the plain version, each
    slice to 4 bf16 ulps of its own largest output.  A row depends only on
    its own query; the whole plain version would need 137 GB of scores."""
    dev = _cuda()
    b, s, h, hk, dh, rows = 1, 32_768, 32, 8, 128, 128
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, s, h, dh, device=dev, generator=g, dtype=torch.bfloat16)
    k = torch.randn(b, s, hk, dh, device=dev, generator=g, dtype=torch.bfloat16)
    v = torch.randn(b, s, hk, dh, device=dev, generator=g, dtype=torch.bfloat16)
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None]
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, pos, pos, causal=True, window=0, block_q=128,
                                    block_k=128, impl="xla_flash")
    assert flash_ops.launches == before + 1
    for sl in (slice(0, rows), slice(s - rows, s)):
        want = attend_naive(q[:, sl].float(), k.float(), v.float(), pos[:, sl], pos, True, 0)
        tol = _every_key_tol(want)
        torch.testing.assert_close(out[:, sl].float(), want, rtol=0, atol=tol)
    assert tol < 2e-3          # the last rows: a few thousandths, held tight


@pytest.mark.parametrize("b,h,hk,dh,t,live", [
    (2, 32, 8, 128, 33_024, 32_769),   # decode_32k: pos 32,768 in a 33,024-slot cache
    (1, 32, 8, 80, 4_096, 4_096),      # danube's ring at long_500k, full
    (1, 16, 1, 256, 2_048, 2_048),     # recurrentgemma's ring at long_500k, full
])
def test_decode_at_the_assigned_lengths_matches_plain(b, h, hk, dh, t, live):
    """The dense decode kernel over the caches the assigned decode shapes
    hold, at small batch: 4 bf16 ulps of max |want|, one launch a call."""
    dev = _cuda()
    q, k, v = _dense_case(dev, 11, b, 0, h, hk, t, dh, torch.bfloat16)
    lens = torch.full((b,), live, device=dev, dtype=torch.int32)
    before = dec_ops.launches
    out, ref = _dense_both(q, k, v, lens, 0)
    assert dec_ops.launches == before + 1
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=_every_key_tol(ref))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_smoke_ring_decode_at_position_524288_on_the_card_matches_the_cpu(arch):
    """The smoke stacks from caches filled as the long_500k run fills them
    (``launch.dryrun.fill_decode_caches``, pos 524,288): 4 decode steps on
    the card (rope at positions past 2**19, the ring kernel at fp32) against
    the CPU, and a launch a layer a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import decode_capacity
    dev = _cuda()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    pos = 524_288
    caches = model.init_caches(2, decode_capacity(pos), "cpu")
    dryrun.fill_decode_caches(caches, pos, torch.Generator().manual_seed(1))
    steps = torch.randint(5, cfg.vocab_size, (4, 2), generator=torch.Generator().manual_seed(2),
                          dtype=torch.int32)
    runs = []
    for device in (torch.device("cpu"), dev):
        p = _to(params, device)
        # copies on both devices: decode writes its caches in place
        c = {group: [{k: t.to(device, copy=True) for k, t in e.items()}
                     for e in caches[group]] for group in ("scan", "rem")}
        c["pos"] = pos
        reset_launch_counts()
        seq = []
        for tok in steps:
            out, c = model.decode_step(p, tok.to(device), c)
            seq.append(out.cpu())
        runs.append(torch.stack(seq))
        if device.type == "cuda":
            assert launch_counts()["decode_attention"] == 4 * attention_layers(cfg)
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-4, atol=1e-4)


# ------------------------- the fp32 panel below dh 32 (several slots a warp)

SMALL_DH = [16, 24, 32]   # a warp takes 2, 4 and 1 slots at once


@pytest.mark.parametrize("b,h,hk,t", [(4, 8, 2, 161), (4, 16, 4, 161), (3, 4, 2, 45),
                                      (2, 8, 1, 700)])
def test_fp32_decode_at_head_dim_24_matches_plain(b, h, hk, t):
    """The dense single-token kernel at dh 24 (8 lanes of 3 elements a key,
    four keys a warp): G 4 (nemotron-4-340b smoke), G 2 (the small LM of
    the reference's serve_e2e), one split and merged splits, ragged lengths
    ending inside a warp's group of keys, a full row and a row at cache_len
    0 (the uniform rule)."""
    dev = _cuda()
    q, k, v = _dense_case(dev, t + 24, b, 0, h, hk, t, 24, torch.float32)
    g = torch.Generator(device=dev).manual_seed(t)
    lens = torch.randint(1, t + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0], lens[-1] = t, 0
    before = dec_ops.launches
    out, ref = _dense_both(q, k, v, lens, 0)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", SMALL_DH)
@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("b,h,hk,t", [(4, 8, 4, 161), (4, 16, 4, 161), (8, 4, 2, 98),
                                      (2, 8, 1, 700)])
def test_fp32_verify_at_small_head_dims_matches_plain(dh, kq, b, h, hk, t):
    """The dense verify block at dh 16, 24 and 32, G 2, 4 and 8, K 1 and 4:
    each row's visible slots end at ``cache_len + i``, inside a warp's
    group of slots, so one slot of a warp is visible to a query and the
    next is not."""
    dev = _cuda()
    q, k, v = _dense_case(dev, t + kq + dh, b, kq, h, hk, t, dh, torch.float32)
    g = torch.Generator(device=dev).manual_seed(t + kq)
    lens = torch.randint(0, t - kq + 1, (b,), device=dev, generator=g, dtype=torch.int32)
    lens[0], lens[-1] = t - kq, 1
    before = dec_ops.block_launches
    out, ref = _dense_both(q, k, v, lens, kq)
    torch.cuda.synchronize()
    assert dec_ops.block_launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", SMALL_DH)
@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("b,h,hk,cap", [(4, 8, 4, 161), (4, 16, 4, 161), (8, 4, 2, 98),
                                        (3, 8, 1, 700)])
def test_fp32_paged_at_small_head_dims_match_plain(dh, kq, page, b, h, hk, cap):
    """Both paged kernels at dh 16, 24 and 32, G 2, 4 and 8: two pinned
    pages shared by every row, a rewound hole at slot 5 beside visible slot
    4 in the same warp, ragged q_pos (the causal limit inside a warp's
    group), the last row parked on TRASH (exactly 0)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(cap + page + kq + dh)
    q, kp, vp, tbl, sp, qpos = _paged_case(dev, g, b, kq, h, hk, dh, page, cap, torch.float32)
    before = (paged_ops.launches, paged_ops.block_launches)
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    torch.cuda.synchronize()
    assert (paged_ops.launches, paged_ops.block_launches) == (before[0] + 1, before[1] + 1)
    ref = paged_decode_attention_block_ref(q, kp, vp, tbl, sp, qpos)
    ref1 = paged_decode_attention_ref(q[:, 0], kp, vp, tbl, sp)
    torch.testing.assert_close(out[:-1], ref[:-1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(one[:-1], ref1[:-1], rtol=1e-5, atol=1e-5)
    assert not out[-1].abs().max() and not one[-1].abs().max()


@pytest.mark.parametrize("dh", SMALL_DH)
@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("g", [2, 4])
def test_fp32_paged_small_head_dims_follow_positions_not_slots(dh, kq, g):
    """Scrambled positions at dh 16, 24 and 32: neighbouring slots of one
    warp hold unrelated positions, so per query some are visible and some
    not; holes, an empty 64-slot stretch, pages never read (out-of-range
    table entries) and a row with no valid slot (exactly 0)."""
    dev = _cuda()
    q, kp, vp, tbl, sp, qpos, ref_tbl = _scrambled_case(dev, kq, g, 16, torch.float32,
                                                        kq + 7 * g + dh, dh=dh)
    out = paged_ops.paged_decode_attention_block(q, kp, vp, tbl, sp, qpos)
    one = paged_ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, sp)
    torch.cuda.synchronize()
    ref = paged_decode_attention_block_ref(q, kp, vp, ref_tbl, sp, qpos)
    ref1 = paged_decode_attention_ref(q[:, 0], kp, vp, ref_tbl, sp)
    torch.testing.assert_close(out[1:], ref[1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(one[1:], ref1[1:], rtol=1e-5, atol=1e-5)
    assert not out[0].abs().max() and not one[0].abs().max()


@pytest.mark.parametrize("dh", SMALL_DH)
def test_fp32_dense_and_paged_small_head_dims_agree(dh):
    """The verify block over a dense cache and over the same rows paged
    (identity positions): the same panel body through DenseKV and PagedKV,
    so the same sums in the same order."""
    dev = _cuda()
    b, kq, h, hk, t, page = 4, 4, 8, 2, 96, 16
    q, k, v = _dense_case(dev, dh, b, kq, h, hk, t, dh, torch.float32)
    lens = torch.tensor([92, 40, 7, 61], device=dev, dtype=torch.int32)
    tbl = torch.arange(b * (t // page), device=dev, dtype=torch.int32).view(b, -1)
    kp, vp = (x.reshape(b * (t // page), page, hk, dh) for x in (k, v))
    slots = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t)
    sp = torch.where(slots < (lens + kq)[:, None], slots, -1).to(torch.int32).contiguous()
    dense = dec_ops.decode_attention_block(q, k, v, lens)
    paged = paged_ops.paged_decode_attention_block(q, kp, vp, tbl.contiguous(), sp, lens)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)
