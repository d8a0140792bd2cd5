"""Unified model configuration covering every assigned architecture family.

One ``ModelConfig`` expresses dense/GQA, sliding-window, MoE (with optional
parallel dense residual, for Arctic), Mamba-2 SSD, RG-LRU hybrids,
encoder-decoder (whisper) and VLM/audio prefix-embedding frontends.

``block_pattern`` is the repeating period of block kinds; heterogeneous
stacks (RecurrentGemma's RG-RG-ATTN) still scan over whole periods, with the
remainder layers applied unscanned.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Block kinds understood by transformer.py
ATTN = "attn"              # global attention + dense MLP
LOCAL_ATTN = "local_attn"  # sliding-window attention + dense MLP
MOE = "moe"                # global attention + MoE FFN (optional dense residual)
MAMBA2 = "mamba2"          # SSD mixer only (no MLP)
RGLRU = "rglru"            # RG-LRU recurrent block + dense MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | audio

    # Core transformer dims.
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # Block layout.
    block_pattern: Tuple[str, ...] = (ATTN,)

    # Attention details.
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = global; >0 = SWA width (for LOCAL_ATTN / all-attn SWA archs)
    attention_impl: str = "auto"     # auto | naive | xla_flash | pallas
    # Flash block sizes are FIXED, never clamped to the sequence (the
    # length-invariance the prefix-prefill contract needs, DESIGN.md §9):
    # short inputs pad UP to one block, so serving configs that run short
    # prefills through xla_flash should size these near their typical
    # length bucket (the tweak-path models use 32).
    flash_block_q: int = 128
    flash_block_k: int = 128

    # MLP.
    mlp_type: str = "swiglu"  # swiglu | gelu | squared_relu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False  # Arctic: parallel dense FFN residual
    capacity_factor: float = 1.0
    router_aux_coef: float = 0.01
    moe_group_size: int = 2048   # GShard dispatch group (tokens); capacity
                                 # scales with the group, so fixed-size groups
                                 # keep dispatch-einsum cost ~ expert cost

    # Mamba-2 SSD.
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # RG-LRU.
    rnn_width: int = 0               # 0 -> d_model
    rglru_c: float = 8.0
    rglru_conv_width: int = 4

    # Encoder-decoder (whisper).
    enc_layers: int = 0
    enc_frames: int = 1500           # stub conv-frontend output length

    # Prefix-embedding frontend (VLM/audio stub).
    frontend: str = "none"           # none | vision_stub | audio_stub
    num_prefix_tokens: int = 0
    frontend_dim: int = 0            # raw embedding dim from the stubbed encoder

    # Numerics / training.
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    max_seq_len: int = 8192
    remat: bool = False
    scan_layers: bool = True
    train_microbatches: int = 1  # grad-accum steps for train_4k (memory lever)

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for even TP sharding."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pattern_periods(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def pattern_remainder(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True iff every block kind decodes with O(1)-or-windowed state."""
        for kind in self.block_pattern:
            if kind in (ATTN, MOE) and self.sliding_window <= 0:
                return False
        return True

    @property
    def decode_cache_len_cap(self) -> int:
        """Max KV entries a cache must physically hold per attention layer."""
        return self.sliding_window if self.sliding_window > 0 else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter-count estimate (exact vocab, analytic).  N for MODEL_FLOPS.
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        per_kind = {}
        attn_p = d * (self.num_heads + 2 * self.num_kv_heads) * dh + self.num_heads * dh * d
        if self.qkv_bias:
            attn_p += (self.num_heads + 2 * self.num_kv_heads) * dh
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        mlp_p = mlp_mult * d * self.d_ff
        per_kind[ATTN] = attn_p + mlp_p
        per_kind[LOCAL_ATTN] = attn_p + mlp_p
        if self.num_experts:
            e = self.num_experts if not active_only else self.experts_per_token
            moe_mlp_mult = 3  # swiglu experts
            moe_p = e * moe_mlp_mult * d * self.moe_d_ff + d * self.num_experts
            if self.moe_dense_residual:
                moe_p += mlp_p
            per_kind[MOE] = attn_p + moe_p
        if self.ssm_state:
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            g = self.ssm_groups
            in_p = d * (2 * di + 2 * g * ns + nh)
            conv_p = (di + 2 * g * ns) * self.ssm_conv_width
            out_p = di * d
            per_kind[MAMBA2] = in_p + conv_p + out_p + 2 * nh + di
        if RGLRU in self.block_pattern:
            w = self.resolved_rnn_width
            per_kind[RGLRU] = d * w * 2 + w * d + w * self.rglru_conv_width + 3 * w + mlp_p
        for i in range(self.num_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            total += per_kind[kind]
        if self.enc_layers:
            total += self.enc_layers * (attn_p + mlp_p)
        return int(total)  # hostsync: ok static config arithmetic, no device values
