"""LLaMA-70B-class architecture — the paper's S4.1 memory validation
(80L, d=8192, ffn=28672, SwiGLU) at spectral rank 32. Unlike the paper's
simplified additive attention, our attention is the real GQA softmax
attention — the memory claim must survive the real thing."""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="llama-70b-sct",
    family="dense_lm",
    seq_parallel=True,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope="rope",
    rope_theta=500_000.0,
    sct=SCTConfig(spectral_mlp=True, rank=32, retraction="qr"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=224, vocab=512, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=8, retraction="qr"),
)
