"""Hand-written Hopper kernels of the port, each beside its plain version.

Each ``<name>/ops.py`` holds the entry points the model calls, each with a
plain integer launch count; ``<name>/ref.py`` holds the plain PyTorch
versions.  The CUDA sources live in ``src/repro_torch/csrc/``.
"""
from .cosine_topk import ops as cosine_topk_ops
from .decode_attention import ops as decode_attention_ops
from .flash_attention import ops as flash_attention_ops
from .paged_attention import ops as paged_attention_ops

# kernel name -> (ops module, name of its launch counter)
OPS = {
    "flash_attention": (flash_attention_ops, "launches"),
    "decode_attention": (decode_attention_ops, "launches"),
    "cosine_topk": (cosine_topk_ops, "launches"),
    "decode_attention_block": (decode_attention_ops, "block_launches"),
    "paged_decode_attention": (paged_attention_ops, "launches"),
    "paged_decode_attention_block": (paged_attention_ops, "block_launches"),
    "cosine_topk_gather": (cosine_topk_ops, "gather_launches"),
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in OPS.items()}


def reset_launch_counts():
    for mod, attr in OPS.values():
        setattr(mod, attr, 0)
