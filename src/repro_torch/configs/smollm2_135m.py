"""SmolLM2-135M — the paper's gradient-integrity model (Table 4). 30L
d_model=576 9H (kv=3) d_ff=1536 vocab=49152. Converted to spectral at
95% energy in benchmarks/table4."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="smollm2-135m",
    family="dense_lm",
    seq_parallel=True,
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    rope="rope",
    rope_theta=100_000.0,
    tie_embeddings=True,
    sct=SCTConfig(spectral_mlp=True, rank=128, energy=0.95, retraction="qr"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16, retraction="qr"),
)
