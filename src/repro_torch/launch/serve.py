"""Build a TweakLLM serving stack on one device (counterpart of
``src/repro/launch/serve.py::build_stack/build_engine``).

Two stacks:

* ``"serve-tiny"`` — the reference's 4L/2L pair (big 4L d128 8H/4kv naive
  attention; small 2L d64 4H/2kv ``xla_flash`` with 32-token blocks) and the
  tiny embedder, vocab 8192 by default; the CPU tests use it.
* ``"llama-3.1-8b"`` — the paper's Small LLM at full width for both roles:
  big = ``configs.llama31_8b.CONFIG`` (it stands in for the frontier Big LLM,
  which no single H100 holds); small = the same config with fixed 64-token
  ``xla_flash`` blocks, so the TWEAK path reuses the instruction-prefix KV;
  embedder = MiniLM at full width (6L d384 12H) over the LM's 128,256-token
  vocabulary; a flat FIFO bank of 262,144 rows.

All weights are random, drawn on the device from ``torch.Generator``s seeded
from ``seed`` (the repo has no public weights).  Off the ported slice —
embedder training, the router cascade (``band > 0``), the IVF index, replica
groups — raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs import llama31_8b
from repro_torch.core.cache import CacheConfig
from repro_torch.core.engine import TweakLLMEngine
from repro_torch.core.router import RouterConfig
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.embedder import MINILM_CONFIG, init_embedder, tiny_embedder_config
from repro_torch.serving.generate import GenerateConfig, Generator
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.tokenizer import HashWordTokenizer

MODELS = ("serve-tiny", "llama-3.1-8b")
LLAMA_FLASH_BLOCK = 64
LLAMA_CAPACITY = 262_144


def model_configs(model: str, vocab: int = 8192):
    """(big, small, embedder) configs of a named stack."""
    if model == "serve-tiny":
        big = ModelConfig(name="big", num_layers=4, d_model=128, num_heads=8,
                          num_kv_heads=4, d_ff=256, vocab_size=vocab,
                          max_seq_len=1024, dtype="float32")
        small = big.replace(name="small", num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, d_ff=128, attention_impl="xla_flash",
                            flash_block_q=32, flash_block_k=32)
        return big, small, tiny_embedder_config(vocab)
    if model == "llama-3.1-8b":
        big = llama31_8b.CONFIG
        small = big.replace(attention_impl="xla_flash", flash_block_q=LLAMA_FLASH_BLOCK,
                            flash_block_k=LLAMA_FLASH_BLOCK)
        return big, small, MINILM_CONFIG.replace(vocab_size=big.vocab_size)
    raise ValueError(f"unknown model {model!r}; known: {MODELS}")


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def build_embedder(model: str = "serve-tiny", *, device="cuda", vocab: int = 8192,
                   seed: int = 0):
    """(embedder params, embedder config): the stack's embedder alone, the
    same weights ``build_stack`` draws for the same arguments."""
    dev = resolve_device(device)
    ecfg = model_configs(model, vocab)[2]
    return init_embedder(ecfg, _generator(dev, seed), dev), ecfg


def build_stack(*, model: str = "serve-tiny", device="cuda", vocab: int = 8192,
                capacity: int = 0, train_embedder_steps: int = 0, policy: str = "fifo",
                index: str = "flat", threshold: float = 0.7, band: float = 0.0,
                max_new_tokens: int = 16, seed: int = 0):
    """Model stack + configs for one engine (``TweakLLMEngine(**stack)``).

    ``capacity`` 0 picks the stack's bank size (4096 tiny, 262,144 llama).
    """
    if train_embedder_steps:
        raise NotImplementedError("embedder training is not ported")
    dev = resolve_device(device)
    big_cfg, small_cfg, ecfg = model_configs(model, vocab)
    vocab = big_cfg.vocab_size
    eparams, ecfg = build_embedder(model, device=dev, vocab=vocab, seed=seed)
    gen_cfg = GenerateConfig(max_new_tokens=max_new_tokens,
                             sampler=SamplerConfig(vocab_size=vocab))
    big_m, small_m = build_model(big_cfg), build_model(small_cfg)
    big = Generator(big_m, big_m.init(_generator(dev, seed + 1), dev), gen_cfg)
    small = Generator(small_m, small_m.init(_generator(dev, seed + 2), dev), gen_cfg)
    if not capacity:
        capacity = LLAMA_CAPACITY if model == "llama-3.1-8b" else 4096
    cache_cfg = CacheConfig(capacity=capacity, dim=ecfg.d_model, policy=policy, index=index)
    return dict(tokenizer=HashWordTokenizer(vocab), embedder_params=eparams,
                embedder_cfg=ecfg, big=big, small=small, cache_cfg=cache_cfg,
                router_cfg=RouterConfig(tweak_threshold=threshold, band=band))


def build_engine(**kw) -> TweakLLMEngine:
    return TweakLLMEngine(**build_stack(**kw))


def build_replica_group(n: int, **kw):
    raise NotImplementedError("replica groups over a shared bank are not ported")
