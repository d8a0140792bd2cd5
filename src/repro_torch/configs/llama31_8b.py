"""llama-3.1-8b [dense] — the paper's Small LLM (Table 1). [Meta AI 2024]

Not one of the 10 assigned architectures; included because TweakLLM's own
configuration pairs it (as the tweaker) with a frontier Big LLM.
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llama-3.1-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, block_pattern=(ATTN,),
    mlp_type="swiglu", norm_type="rmsnorm", rope_theta=500_000.0,
    max_seq_len=32768 + 8, dtype="bfloat16", remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, max_seq_len=128, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention dense"}
