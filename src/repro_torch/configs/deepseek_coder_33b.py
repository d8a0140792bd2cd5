"""deepseek-coder-33b [dense] — llama-arch GQA. [arXiv:2401.14196]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
56 heads don't divide the 16-way model axis -> embed-dim TP fallback
(see launch/sharding.py).  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, block_pattern=(ATTN,),
    mlp_type="swiglu", norm_type="rmsnorm", rope_theta=100_000.0,
    max_seq_len=32768 + 8, dtype="bfloat16", remat=True, train_microbatches=16,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention dense"}
