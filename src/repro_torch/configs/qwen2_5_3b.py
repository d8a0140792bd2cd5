"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, block_pattern=(ATTN,),
    qkv_bias=True, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0, max_seq_len=32768 + 8,
    dtype="bfloat16", remat=True, train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention dense"}
