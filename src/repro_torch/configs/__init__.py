"""Architecture registry of the port (counterpart of ``src/repro/configs``).

``get_config(arch, smoke)`` resolves the reference's ids whose stack the port
builds: decoder-only global-attention (ATTN) stacks without QKV bias, with
a swiglu or gelu MLP.  Their config modules are copies of the reference's.
Every other id raises ``NotImplementedError`` naming what the port lacks for
it; an unknown id raises ``KeyError`` as in the reference.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "llama-3.1-8b": "llama31_8b",
}

# what each reference id needs that the port does not build yet
MISSING = {
    "deepseek-coder-33b": "its config (a plain llama-arch stack; no caller needs it yet)",
    "whisper-tiny": "enc-dec (audio frontend, cross attention), qkv_bias",
    "qwen2.5-3b": "qkv_bias",
    "recurrentgemma-9b": "RG-LRU blocks, sliding window (local attention)",
    "h2o-danube-1.8b": "sliding window",
    "internvl2-26b": "vision frontend (prefix embeddings)",
    "arctic-480b": "MoE (dense residual)",
    "mamba2-130m": "SSM (Mamba-2)",
    "qwen3-moe-235b-a22b": "MoE",
    "nemotron-4-340b": "squared_relu",
}


def get_arch(arch_id: str):
    """The config module of ``arch_id`` (CONFIG, SMOKE_CONFIG, SKIP_SHAPES)."""
    if arch_id in MISSING:
        raise NotImplementedError(f"{arch_id}: the port does not build {MISSING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES) + sorted(MISSING)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str, smoke: bool = False):
    mod = get_arch(arch_id)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def skip_reason(arch_id: str, shape: str):
    return get_arch(arch_id).SKIP_SHAPES.get(shape)
