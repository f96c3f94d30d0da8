"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20, i.e. MHA) d_ff=6912
vocab=151936. QKV bias [hf:Qwen/Qwen1.5-4B; hf]."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense_lm",
    seq_parallel=True,
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
