"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Largest dense config: remat + microbatching are mandatory for train_4k.
Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, block_pattern=(ATTN,),
    mlp_type="squared_relu", norm_type="layernorm",
    max_seq_len=32768 + 8, dtype="bfloat16", remat=True, train_microbatches=16,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=192, num_heads=8, num_kv_heads=2, head_dim=24,
    d_ff=768, vocab_size=512, max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention dense"}
