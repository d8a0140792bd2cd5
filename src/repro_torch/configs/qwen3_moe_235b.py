"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936,
MoE 128e top-8, no shared/dense expert.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, block_pattern=(MOE,),
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    capacity_factor=1.25, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0, max_seq_len=32768 + 8,
    dtype="bfloat16", remat=True, train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, num_experts=4, experts_per_token=2, moe_d_ff=96,
    max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention MoE"}
