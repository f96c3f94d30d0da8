"""ModelConfig: one dataclass describing every assigned architecture,
plus the SCT (paper technique) settings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SCTConfig:
    """Paper technique settings (core/). Defaults are paper-faithful:
    spectral MLP, dense attention, QR retraction every step."""
    spectral_mlp: bool = True
    rank: int = 128                      # paper's Pareto-optimal rank
    spectral_attention: bool = False     # paper S5: future work; our option
    spectral_mamba: bool = False         # jamba mixer projections option
    retraction: str = "qr"               # qr | cholesky_qr2 | cayley
    retract_every: int = 1               # paper: every step
    energy: Optional[float] = None       # e.g. 0.95 -> rank from energy (S4.4)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense_lm | moe_lm | hybrid | ssm_lm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"                   # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    act: str = "swiglu"                  # swiglu | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0          # deepseek: leading dense MLP layers
    moe_every: int = 1                   # jamba: MoE on every 2nd layer
    moe_norm_topk: bool = True
    aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    attention: str = "gqa"               # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (jamba) ---
    attn_every: int = 0                  # 0 -> all layers attention; 8 -> 1-in-8
    attn_offset: int = 4                 # position of the attn layer in the period
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # --- xlstm ---
    slstm_every: int = 0                 # 0 -> no sLSTM; 8 -> 1-in-8 layers
    slstm_offset: int = 7

    # --- encdec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500              # whisper 30s -> 1500 frames (stubbed)

    # --- SCT ---
    sct: SCTConfig = dataclasses.field(default_factory=SCTConfig)

    # --- numerics / runtime ---
    dtype: str = "bfloat16"              # compute dtype (params fp32 master)
    remat: bool = True
    use_pallas: bool = False
    max_seq: int = 4096
    # sequence-parallel layer-boundary activations (measured win for
    # dense families; conflicts with the MoE shard_map x-layout, see
    # EXPERIMENTS.md §Perf) — set per arch config
    seq_parallel: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.attn_every and self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank", -(-self.d_model // 16))

    @property
    def mlp_rank(self) -> Optional[int]:
        return self.sct.rank if self.sct.spectral_mlp else None

    @property
    def attn_rank(self) -> Optional[int]:
        return self.sct.rank if self.sct.spectral_attention else None

    @property
    def mamba_rank(self) -> Optional[int]:
        return self.sct.rank if self.sct.spectral_mamba else None

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can decode a 500k-token context without quadratic attention /
        unbounded KV growth dominating? True for SSM/hybrid families."""
        return self.family in ("ssm_lm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def replace_sct(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, sct=dataclasses.replace(self.sct, **kw))
