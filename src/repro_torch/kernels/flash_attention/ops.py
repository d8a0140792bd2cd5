"""Prefill attention entry point: the Hopper kernel on CUDA, plain on CPU.

Replaces ``src/repro/kernels/flash_attention`` (the Pallas kernel) with
``csrc/flash_attention.cu``, which computes the position-aware function of
``_attend_xla_flash``.  A CPU tensor takes the plain version in ``ref``; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import build
from . import ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                    block_q: int, block_k: int, impl: str = "xla_flash"):
    """q (B,Sq,H,dh), k/v (B,Sk,Hk,dh), q_pos (B,Sq), k_pos (B,Sk) int32.

    ``impl`` names the reference semantics the CPU path follows ("naive"
    full-axis softmax or "xla_flash" fixed blocks).  On CUDA both run the
    kernel, which computes the same function; under "xla_flash" ``block_k``
    fixes how far the keys are padded, under "naive" they are not padded.
    ``block_q`` has no effect on real rows.
    """
    if q.device.type == "cpu":
        if impl == "naive":
            return ref.attend_naive(q, k, v, q_pos, k_pos, causal, window)
        return ref.attend_blockwise(q, k, v, q_pos, k_pos, causal, window,
                                    block_q, block_k)
    global launches
    dev = build.require_cuda("flash_attention", q, k, v, q_pos, k_pos)
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in (64, 128) or h % hk or k.shape != (b, sk, hk, dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (dh 64 or 128)")
    if (q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32
            or q_pos.shape != (b, sq) or k_pos.shape != (b, sk)):
        raise ValueError("flash_attention: q_pos (B,Sq) and k_pos (B,Sk) must be int32")
    sk_pad = sk if impl == "naive" else -(-sk // block_k) * block_k
    out = torch.empty_like(q)
    lib = build.load_library()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), b, sq, sk, sk_pad, h, hk, dh, build.DTYPE_CODES[q.dtype],
        int(causal), int(window), float(dh) ** -0.5, build.stream_ptr(dev))
    build.check(rc, "flash_attention")
    launches += 1
    return out
