"""Prefill attention entry point: the Hopper kernel on CUDA, plain on CPU.

Replaces ``src/repro/kernels/flash_attention`` (the Pallas kernel) with
``csrc/flash_attention.cu``, which computes the position-aware function of
``_attend_xla_flash``.  A CPU tensor takes the plain version in ``ref``; a
CUDA tensor launches the kernel or raises.

The call is differentiable: when grad mode is on and q, k or v requires
grad it runs inside a ``torch.autograd.Function`` whose forward is that same
dispatch and whose backward is ``ref.attend_grads``, plain tensor arithmetic
on both devices (the reference differentiates its XLA attention; it has no
backward kernel).  Without grad the call is the kernel launch alone.

:func:`launch_plan` states how the kernel cuts the work (it mirrors the
constants of ``csrc/flash_attention.cu``): bf16 runs on the tensor cores in
blocks of ``M_TILE`` (query, head) pairs of one KV group, walking key tiles
of ``KEY_TILE`` keys counted from key 0; fp32 runs on the CUDA cores in
blocks of 16 queries of one head.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import build
from . import ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""

M_TILE = 64          # (query, head) rows per tensor-core block (kBM)
KEY_TILE = 64        # keys per tile of the tensor-core body (kBN)
SIMT_QUERIES = 16    # query rows per fp32 block (kBQ)
SIMT_KEY_TILE = 32   # keys per fp32 tile (kBK)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into blocks.

    ``route`` "mma" (bf16, tensor cores) or "simt" (fp32, CUDA cores);
    ``grid`` the (x, y, z) block counts; ``smem_bytes`` the dynamic shared
    memory of a block; ``sk_pad`` the keys the softmax runs over (past Sk
    they are zeros at position 2**30); ``g`` query heads per KV head.
    """
    route: str
    grid: tuple
    smem_bytes: int
    sk_pad: int
    g: int

    @property
    def key_tiles(self):
        """(start, stop) of each key tile, counted from key 0: a function of
        ``sk_pad`` alone."""
        tile = KEY_TILE if self.route == "mma" else SIMT_KEY_TILE
        return tuple((s, min(s + tile, self.sk_pad)) for s in range(0, self.sk_pad, tile))


def padded_keys(sk: int, impl: str, block_k: int) -> int:
    """The keys the softmax runs over: Sk under "naive", Sk rounded up to
    whole ``block_k`` blocks under "xla_flash" (zero keys at position 2**30)."""
    return sk if impl == "naive" else -(-sk // block_k) * block_k


def launch_plan(b: int, sq: int, sk: int, h: int, hk: int, dh: int, dtype,
                impl: str, block_k: int) -> LaunchPlan:
    sk_pad = padded_keys(sk, impl, block_k)
    g = h // hk
    if dtype == torch.bfloat16:
        ntiles = -(-sk_pad // KEY_TILE)
        # Q tile + two (K, V) buffers of bf16 rows, two tiles of key positions,
        # one flag per key tile rounded up to 16 bytes (MmaSmem in the source)
        smem = (M_TILE + 4 * KEY_TILE) * dh * 2 + 2 * KEY_TILE * 4 + -(-ntiles // 16) * 16
        return LaunchPlan("mma", (-(-sq * g // M_TILE), hk, b), smem, sk_pad, g)
    return LaunchPlan("simt", (-(-sq // SIMT_QUERIES), h, b), 0, sk_pad, g)


def block_rows(plan: LaunchPlan, block, sq: int):
    """The (b, query, head) output rows that block (x, y, z) computes."""
    x, y, z = block
    if plan.route == "mma":
        pairs = range(x * M_TILE, min((x + 1) * M_TILE, sq * plan.g))
        return [(z, p // plan.g, y * plan.g + p % plan.g) for p in pairs]
    return [(z, qi, y) for qi in range(x * SIMT_QUERIES, min((x + 1) * SIMT_QUERIES, sq))]


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                    block_q: int, block_k: int, impl: str = "xla_flash"):
    """q (B,Sq,H,dh), k/v (B,Sk,Hk,dh), q_pos (B,Sq), k_pos (B,Sk) int32.

    ``impl`` names the reference semantics the CPU path follows ("naive"
    full-axis softmax or "xla_flash" fixed blocks).  On CUDA both run the
    kernel, which computes the same function; under "xla_flash" ``block_k``
    fixes how far the keys are padded, under "naive" they are not padded.
    ``block_q`` has no effect on real rows.  Differentiable in q, k and v
    (module docstring).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window, block_q,
                                     block_k, impl)
    return _forward(q, k, v, q_pos, k_pos, causal, window, block_q, block_k, impl)


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, on a CPU tensor, the plain version) forward; the
    plain backward of ``ref.attend_grads`` over the same padded keys."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, block_q, block_k, impl):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.mask = (causal, window, padded_keys(k.shape[1], impl, block_k))
        return _forward(q, k, v, q_pos, k_pos, causal, window, block_q, block_k, impl)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        causal, window, sk_pad = ctx.mask
        dq, dk, dv = ref.attend_grads(q, k, v, q_pos, k_pos, d_out, causal, window, sk_pad)
        return dq, dk, dv, None, None, None, None, None, None, None


def _forward(q, k, v, q_pos, k_pos, causal, window, block_q, block_k, impl):
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
    head_dims = (16, 64, 128) if q.dtype == torch.float32 else (64, 128)
    if dh not in head_dims or h % hk or k.shape != (b, sk, hk, dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (dh {head_dims} for "
                         f"{q.dtype})")
    if (q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32
            or q_pos.shape != (b, sq) or k_pos.shape != (b, sk)):
        raise ValueError("flash_attention: q_pos (B,Sq) and k_pos (B,Sk) must be int32")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    plan = launch_plan(b, sq, sk, h, hk, dh, q.dtype, impl, block_k)
    if plan.smem_bytes > build.SMEM_PER_BLOCK:
        raise ValueError(f"flash_attention: {plan.smem_bytes} bytes of shared memory "
                         f"exceed {build.SMEM_PER_BLOCK} (Sk_pad {plan.sk_pad})")
    out = torch.empty_like(q)
    lib = build.load_library()
    rc = build.launch(
        dev, lib.flash_attention_launch, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(), b, sq, sk, plan.sk_pad, h, hk, dh,
        build.DTYPE_CODES[q.dtype], int(causal), int(window), float(dh) ** -0.5)
    build.check(rc, "flash_attention")
    launches += 1
    return out
