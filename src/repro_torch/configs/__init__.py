"""Architecture registry of the port (counterpart of ``src/repro/configs``).

``get_config(arch, smoke)`` resolves the reference's ids whose stack the port
builds, which since the encoder-decoder and the vision prefix are all ten:
decoder-only ATTN stacks, global or sliding-window, with or without QKV
bias, with a swiglu, gelu or squared-ReLU MLP, MOE stacks (GShard top-k
capacity dispatch, with or without Arctic's dense residual), the Mamba-2
stack, the RG-LRU / local-attention hybrid, whisper's encoder-decoder and
internvl2's prefix-embedding frontend.  Their config modules are copies of
the reference's.  An id in ``MISSING`` would raise ``NotImplementedError``
naming what the port lacks for it; an unknown id raises ``KeyError`` as in
the reference.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "llama-3.1-8b": "llama31_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-26b": "internvl2_26b",
}

# the ten assigned architectures, every id but the paper's own llama-3.1-8b, in
# the reference's order (the dry-run's ``--all`` walks them so)
ASSIGNED_ARCHS = ("whisper-tiny", "qwen2.5-3b", "recurrentgemma-9b", "deepseek-coder-33b",
                  "h2o-danube-1.8b", "internvl2-26b", "arctic-480b", "mamba2-130m",
                  "qwen3-moe-235b-a22b", "nemotron-4-340b")

# what each reference id needs that the port does not build yet (none now)
MISSING: dict = {}


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
