"""whisper-medium [audio] — 24L d_model=1024 16H d_ff=4096 vocab=51865.
Encoder-decoder; conv frontend is a STUB (input_specs supplies
precomputed frame embeddings) [arXiv:2212.04356; unverified].
"""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    seq_parallel=True,
    n_layers=24,               # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,
    rope="none",               # whisper uses learned absolute positions
    act="gelu",
    norm="layernorm",
    encoder_seq=1500,
    max_seq=32_768,            # decode_32k cell needs positions up to 32k
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, encoder_seq=32, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
