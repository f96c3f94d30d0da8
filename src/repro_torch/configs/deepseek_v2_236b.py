"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 (expert)
vocab=102400, MoE 160e top-6, MLA kv_lora=512, 2 shared experts, first
layer dense (d_ff=12288) [arXiv:2405.04434; hf]."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe_lm",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,
    moe_d_ff=1536,
    vocab=102400,
    rope="rope",
    rope_theta=10_000.0,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    capacity_factor=1.25,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, moe_d_ff=48,
    vocab=512, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, head_dim=24, n_experts=4,
    n_shared_experts=2, top_k=2, first_dense_layers=1, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
