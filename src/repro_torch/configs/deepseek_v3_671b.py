"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (expert)
vocab=129280, MoE 256e top-8, MLA (kv_lora=512, q_lora=1536), 1 shared
expert, first 3 layers dense (d_ff=18432) [arXiv:2412.19437; hf].

This is SCT's most valuable cell: routed-expert MLPs hold ~95% of the
parameters, and every expert is spectral. MTP (multi-token prediction)
is a training objective add-on, not an architecture change; noted as not
implemented (DESIGN.md S7).
"""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe_lm",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # the first_dense_layers MLP width
    moe_d_ff=2048,
    vocab=129280,
    rope="rope",
    rope_theta=10_000.0,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,             # nope + rope
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    first_dense_layers=3,
    capacity_factor=1.25,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, moe_d_ff=48,
    vocab=512, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, head_dim=24, n_experts=4,
    n_shared_experts=1, top_k=2, first_dense_layers=1, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
