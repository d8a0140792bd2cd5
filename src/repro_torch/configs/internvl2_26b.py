"""internvl2-26b [vlm] — InternViT frontend (stub) + InternLM2 decoder.
[arXiv:2404.16821]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The InternViT-6B
vision encoder + MLP projector are the allowed stub: input_specs supplies
256 patch embeddings (dim 3200, InternViT hidden) which the built-in
projector maps into the decoder.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, block_pattern=(ATTN,),
    mlp_type="swiglu", norm_type="rmsnorm",
    frontend="vision_stub", num_prefix_tokens=256, frontend_dim=3200,
    max_seq_len=32768 + 264, dtype="bfloat16", remat=True, train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, num_prefix_tokens=8, frontend_dim=64,
    max_seq_len=160, dtype="float32", remat=False)

SKIP_SHAPES = {"long_500k": "full-attention dense decoder"}
