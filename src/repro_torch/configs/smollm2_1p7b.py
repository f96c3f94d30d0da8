"""SmolLM2-1.7B — the paper's rank-sweep model (Table 3). 24L
d_model=2048 32H d_ff=8192 vocab=49152. MLP layer (2048 x 8192) matches
the paper's Table 1 row."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="smollm2-1.7b",
    family="dense_lm",
    seq_parallel=True,
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=49152,
    rope="rope",
    rope_theta=130_000.0,
    tie_embeddings=True,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="qr"),  # paper-faithful
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16, retraction="qr"),
)
