"""Hand-written Hopper kernels of the port, each beside its plain version.

Each ``<name>/ops.py`` holds the entry point the model calls and a plain
integer ``launches`` count; ``<name>/ref.py`` holds the plain PyTorch
version.  The CUDA sources live in ``src/repro_torch/csrc/``.
"""
from .cosine_topk import ops as cosine_topk_ops
from .decode_attention import ops as decode_attention_ops
from .flash_attention import ops as flash_attention_ops

OPS = {
    "flash_attention": flash_attention_ops,
    "decode_attention": decode_attention_ops,
    "cosine_topk": cosine_topk_ops,
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in OPS.items()}


def reset_launch_counts():
    for mod in OPS.values():
        mod.launches = 0
