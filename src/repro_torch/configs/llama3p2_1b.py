"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense_lm",
    seq_parallel=True,
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    rope="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
