"""The port on an NVIDIA GPU: each Hopper kernel against its plain PyTorch
version, and a small engine served on the card against the same engine on
the CPU.  Every test is marked ``cuda`` and skips without a card.  This
file imports no JAX, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 kernels 1e-5 (summation order differs from the plain
version's); bf16 2e-2 (bf16 output rounding, ulp 2**-8 near 1).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import router
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cosine_topk import ops as cos_ops
from repro_torch.kernels.cosine_topk.ref import cosine_topk_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attend_blockwise, attend_naive
from repro_torch.launch.serve import model_configs
from repro_torch.models import build_model
from repro_torch.models.embedder import init_embedder
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -q -m cuda "
                    "tests/test_torch_cuda.py on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("impl", ["xla_flash", "naive"])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,p,s,h,hk,dh,block,window", [
    (2, 45, 64, 8, 2, 128, 64, 0),     # TWEAK suffix over a stored prefix
    (3, 0, 37, 4, 4, 64, 32, 0),       # ragged plain prefill
    (1, 10, 50, 8, 4, 64, 16, 12),     # sliding window
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _small_engine(device, vocab=2048):
    """serve-tiny widened to head dim 64 (the kernels take 64 or 128), with
    weights drawn on the CPU and moved to ``device``."""
    big_cfg, small_cfg, ecfg = model_configs("serve-tiny", vocab)
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
                          cache_cfg=CacheConfig(capacity=256, dim=ecfg.d_model),
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
        assert min(counts.values()) > 0 if device.type == "cuda" else max(counts.values()) == 0
    (r_cpu, m_cpu), (r_gpu, m_gpu) = out["cpu"], out["cuda"]
    assert [m["decision"] for m in m_gpu] == [m["decision"] for m in m_cpu]
    assert {m["decision"] for m in m_gpu} >= {router.EXACT, router.MISS}
    np.testing.assert_allclose([m["sim"] for m in m_gpu], [m["sim"] for m in m_cpu],
                               atol=1e-5)
    assert r_gpu == r_cpu
