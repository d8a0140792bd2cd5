"""mamba2-130m [ssm] — SSD, attention-free. [arXiv:2405.21060]

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128, head_dim 64, expand 2.
O(1) decode state -> runs long_500k natively.
"""
from repro_torch.models.config import ModelConfig, MAMBA2

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=1, num_kv_heads=1, d_ff=0,
    vocab_size=50280, block_pattern=(MAMBA2,),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    norm_type="rmsnorm", max_seq_len=524_288 + 8,
    dtype="bfloat16", tie_embeddings=True, train_microbatches=2,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=128, vocab_size=512, ssm_state=16, ssm_head_dim=32,
    ssm_chunk=16, max_seq_len=128, dtype="float32")

SKIP_SHAPES = {}
