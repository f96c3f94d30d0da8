"""xlstm-1.3b [ssm] — 48L d_model=2048 4H vocab=50304, d_ff=0 (blocks
carry their own projections); sLSTM:mLSTM 1:7 [arXiv:2405.04517;
unverified]. Sub-quadratic: runs the long_500k decode cell.
"""
from repro_torch.config.model_config import ModelConfig, SCTConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm_lm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab=50304,
    rope="none",
    slstm_every=8,
    slstm_offset=7,
    sct=SCTConfig(spectral_mlp=True, rank=128, retraction="cholesky_qr2"),
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    vocab=512, slstm_every=2, slstm_offset=1, max_seq=64,
    sct=SCTConfig(spectral_mlp=True, rank=16),
)
