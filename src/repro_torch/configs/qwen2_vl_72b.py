"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: the transformer
backbone consumes token embeddings; ``repro.data.vision_stub`` can merge
precomputed patch embeddings. M-RoPE is real (nn/rotary.py) and reduces
to RoPE on text-only positions.
"""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="dense_lm",
    seq_parallel=True,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,              # qwen2 uses QKV bias
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    sct=SCTConfig(spectral_mlp=True, rank=256, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, max_seq=64, mrope_sections=(2, 3, 3),
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
