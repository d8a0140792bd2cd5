"""h2o-danube-1.8b [dense] — llama+mistral mix with SWA. [arXiv:2401.16818]

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
Windowed KV cache -> sub-quadratic decode -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000, block_pattern=(ATTN,),
    sliding_window=4096, mlp_type="swiglu", norm_type="rmsnorm",
    max_seq_len=524_288 + 8, dtype="bfloat16", remat=True, train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, sliding_window=16, max_seq_len=128,
    dtype="float32", remat=False)

SKIP_SHAPES = {}
