"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and run on the CPU only when the
caller asks for it.  There is no silent CPU path: asking for CUDA on a
machine without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device, with TF32 switched off for fp32 products."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    # fp32 products in full precision, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def to_device(array, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without waiting for the stream."""
    return torch.as_tensor(array).to(device, non_blocking=True)
