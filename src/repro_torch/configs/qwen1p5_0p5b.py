"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936. QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense_lm",
    seq_parallel=True,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
