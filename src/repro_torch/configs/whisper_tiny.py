"""whisper-tiny [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.  The mel-spectrogram +
conv feature extractor is the allowed stub: input_specs supplies 1500
post-conv frame embeddings.  Decoder is full-attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, enc_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, block_pattern=(ATTN,),
    mlp_type="gelu", norm_type="layernorm", qkv_bias=True,
    enc_frames=1500, frontend="audio_stub", frontend_dim=384,
    max_seq_len=524_288 + 8, dtype="bfloat16", tie_embeddings=True,
    remat=True, train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, enc_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, enc_frames=16, frontend_dim=128,
    max_seq_len=128, dtype="float32", remat=False, train_microbatches=1)

SKIP_SHAPES = {"long_500k": "full-attention enc-dec decoder"}
