"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual.
[hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic's dense-MoE hybrid: a small dense FFN runs in parallel (residual)
with the MoE per layer.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000, block_pattern=(MOE,),
    num_experts=128, experts_per_token=2, moe_d_ff=4864,
    moe_dense_residual=True, capacity_factor=2.0,
    mlp_type="swiglu", norm_type="rmsnorm",
    max_seq_len=32768 + 8, dtype="bfloat16", remat=True, train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, num_experts=4, experts_per_token=2, moe_d_ff=96,
    max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention MoE"}
