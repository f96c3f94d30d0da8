"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2. Mamba+attention 1:7 interleave, MoE every
2nd layer [arXiv:2403.19887; hf]. No positional embeddings (mamba
provides position information).
"""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab=65536,
    rope="none",
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    mamba_expand=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    sct=SCTConfig(spectral_mlp=True, rank=256, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, vocab=512, n_experts=4, top_k=2,
    attn_every=4, attn_offset=2, mamba_dt_rank=8, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
