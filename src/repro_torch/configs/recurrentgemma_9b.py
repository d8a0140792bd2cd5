"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2. [arXiv:2402.19427]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern (RG-LRU, RG-LRU, local-attn): 12 periods + (RG, RG) remainder.
Local window 2048 + recurrent state -> sub-quadratic -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig, RGLRU, LOCAL_ATTN

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN), sliding_window=2048,
    rnn_width=4096, mlp_type="swiglu", norm_type="rmsnorm",
    max_seq_len=524_288 + 8, dtype="bfloat16", remat=True, train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512, sliding_window=16, rnn_width=128,
    max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {}
