"""Decoder-only language models of three families:

  dense_lm — llama3.2-1b, granite-3-2b, qwen1.5, smollm2, llama-70b-sct:
             token embedding, RMSNorm, GQA attention with RoPE, a SwiGLU
             MLP whose projections are spectral, the tied LM head;
  ssm_lm   — xlstm-1.3b: periods of ``slstm_every`` blocks, the sLSTM at
             ``slstm_offset`` and mLSTMs elsewhere (nn/xlstm.py), each
             block pre-normed with a residual;
  hybrid   — jamba-v0.1-52b: periods of ``attn_every`` layers, GQA
             attention (no RoPE) at ``attn_offset`` and mamba mixers
             elsewhere (nn/mamba.py), each followed by an MoE
             (nn/moe.py) on every ``moe_every``-th layer and a spectral
             SwiGLU MLP on the others; the MoE's load-balance loss is the
             forward's aux loss.

Parameters keep the reference's stacked layout — every leaf under
``layers`` carries a leading ``n_layers`` axis (``layers/mlp/up/U`` is
``(L, m, k)``), every leaf under ``periods`` a leading period axis — so
an npz checkpoint maps onto them key for key. The layer loop is a Python
loop over views of those stacks; with ``cfg.remat`` each layer (or
period) body is recomputed in the backward (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` with ``nothing_saveable``).

:func:`require_family` is the gate: it names what each family supports
(``SUPPORT``) and raises ``NotImplementedError`` for the rest.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.model_config import ModelConfig
from repro_torch.core.tree import stack_trees, unstack_tree
from repro_torch.device import compute_dtype
from repro_torch.nn import attention as attn
from repro_torch.nn import mamba as mamba_mod
from repro_torch.nn import xlstm as xlstm_mod
from repro_torch.nn.embedding import apply_embedding, apply_lm_head, init_embedding
from repro_torch.nn.mlp import apply_mlp, init_mlp
from repro_torch.nn.moe import apply_moe, init_moe
from repro_torch.nn.norms import apply_rmsnorm, init_rmsnorm

Params = Dict[str, Any]


# what the port runs, by family: parameter init and the forward (with its
# loss value), serving (prefill and decode), training (gradients)
SUPPORT = {"dense_lm": ("init", "forward", "serve", "train"),
           "ssm_lm": ("init", "forward", "serve"),
           "hybrid": ("init", "forward", "serve")}


def require_family(cfg: ModelConfig, path: str) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``path`` (one of
    init, forward, serve, train) for ``cfg``'s family."""
    if path not in SUPPORT.get(cfg.family, ()):
        if cfg.family == "ssm_lm" and path == "train":
            raise NotImplementedError(
                "training the ssm_lm family is the next slice of the port: it needs "
                "hand-written backward kernels for the mLSTM chunk and the sLSTM scan")
        if cfg.family == "hybrid" and path == "train":
            raise NotImplementedError(
                "training the hybrid family is not ported yet: it needs a hand-written "
                "backward kernel for the selective scan")
        ported = ", ".join(f"{fam} ({'/'.join(paths)})" for fam, paths in SUPPORT.items())
        raise NotImplementedError(f"family {cfg.family!r}: {path} is not ported yet "
                                  f"(the port runs {ported})")
    if cfg.norm != "rmsnorm" or (cfg.family != "ssm_lm" and cfg.attention != "gqa"):
        raise NotImplementedError(
            f"attention={cfg.attention!r}, norm={cfg.norm!r}: only GQA with "
            f"RMSNorm is ported")


def _norm_apply(cfg, p, x):
    return apply_rmsnorm(p, x)


def _init_dense_layer(cfg, generator, device):
    kw = dict(generator=generator, device=device)
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, device=device),
        "attn": attn.init_gqa(cfg, **kw),
        "mlp_norm": init_rmsnorm(cfg.d_model, device=device),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, rank=cfg.mlp_rank, act=cfg.act, **kw),
    }


def _init_xlstm_period(cfg, generator, device):
    """One xlstm period: slstm_every blocks; the sLSTM at slstm_offset."""
    kw = dict(generator=generator, device=device)
    layers = {}
    for p in range(cfg.slstm_every):
        body = ({"slstm": xlstm_mod.init_slstm(cfg, **kw)} if p == cfg.slstm_offset
                else {"mlstm": xlstm_mod.init_mlstm(cfg, **kw)})
        layers[f"p{p}"] = {"pre_norm": init_rmsnorm(cfg.d_model, device=device), **body}
    return layers


def _init_hybrid_period(cfg, generator, device):
    """One jamba period: attn_every layers; attention at attn_offset, mamba
    elsewhere; MoE where ``is_moe_layer``, a dense (spectral) MLP
    elsewhere."""
    kw = dict(generator=generator, device=device)
    layers = {}
    for p in range(cfg.attn_every):
        mixer = ({"attn": attn.init_gqa(cfg, **kw)} if p == cfg.attn_offset
                 else {"mamba": mamba_mod.init_mamba(cfg, **kw)})
        ff = ({"moe": init_moe(cfg, **kw)} if is_moe_layer(cfg, p)
              else {"mlp": init_mlp(cfg.d_model, cfg.d_ff, rank=cfg.mlp_rank, act=cfg.act,
                                    **kw)})
        layers[f"p{p}"] = {"pre_norm": init_rmsnorm(cfg.d_model, device=device), **mixer,
                           "ff_norm": init_rmsnorm(cfg.d_model, device=device), **ff}
    return layers


def is_moe_layer(cfg: ModelConfig, p: int) -> bool:
    """Whether position ``p`` of a hybrid period carries the MoE."""
    return cfg.n_experts > 0 and p % cfg.moe_every == cfg.moe_every - 1


def n_periods(cfg: ModelConfig) -> int:
    """Periods of a heterogeneous stack: jamba's attn_every layers, xlstm's
    slstm_every blocks."""
    return cfg.n_layers // (cfg.attn_every if cfg.family == "hybrid" else cfg.slstm_every)


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: torch.device) -> Params:
    """fp32 master parameters in the reference's layout."""
    require_family(cfg, "init")
    params: Params = {
        "embed": init_embedding(cfg.vocab, cfg.d_model, generator=generator, device=device)}
    if cfg.family in ("ssm_lm", "hybrid"):
        init_period = _init_hybrid_period if cfg.family == "hybrid" else _init_xlstm_period
        params["periods"] = stack_trees(
            [init_period(cfg, generator, device) for _ in range(n_periods(cfg))])
    else:
        params["layers"] = stack_trees(
            [_init_dense_layer(cfg, generator, device) for _ in range(cfg.n_layers)])
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=device)
    return params


def _dense_block(cfg, p, x, positions, rope=None):
    h = _norm_apply(cfg, p["attn_norm"], x)
    x = x + attn.apply_gqa(p["attn"], h, cfg, positions=positions, rope=rope)
    h = _norm_apply(cfg, p["mlp_norm"], x)
    return x + apply_mlp(p["mlp"], h, act=cfg.act)


def ff_apply(cfg, lp, h):
    """A hybrid layer's feed-forward: (output, the MoE's aux loss or None)."""
    if "moe" in lp:
        return apply_moe(lp["moe"], h, cfg, capacity_factor=cfg.capacity_factor)
    return apply_mlp(lp["mlp"], h, act=cfg.act), None


def _hybrid_period_fwd(cfg, pp, x, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(cfg.attn_every):
        lp = pp[f"p{p}"]
        h = _norm_apply(cfg, lp["pre_norm"], x)
        if "attn" in lp:
            h = attn.apply_gqa(lp["attn"], h, cfg, positions=positions)
        else:
            h = mamba_mod.apply_mamba(lp["mamba"], h, cfg)
        x = x + h
        h, a = ff_apply(cfg, lp, _norm_apply(cfg, lp["ff_norm"], x))
        if a is not None:
            aux = aux + a
        x = x + h
    return x, aux


def _xlstm_period_fwd(cfg, pp, x):
    for p in range(cfg.slstm_every):
        lp = pp[f"p{p}"]
        h = _norm_apply(cfg, lp["pre_norm"], x)
        if "slstm" in lp:
            h = xlstm_mod.apply_slstm(lp["slstm"], h, cfg)
        else:
            h = xlstm_mod.apply_mlstm(lp["mlstm"], h, cfg)
        x = x + h
    return x


def forward_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (b, s) -> (logits (b, s, vocab), aux_loss): the hybrid
    family's summed MoE load-balance loss, 0.0 for the others."""
    require_family(cfg, "forward")
    b, s = tokens.shape
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.family == "ssm_lm":
        stack, count = params["periods"], n_periods(cfg)

        def body(p, h):
            return _xlstm_period_fwd(cfg, p, h), None
    elif cfg.family == "hybrid":
        stack, count = params["periods"], n_periods(cfg)

        def body(p, h):
            return _hybrid_period_fwd(cfg, p, h, positions)
    else:
        stack, count = params["layers"], cfg.n_layers
        rope = attn.step_rope(cfg, positions)

        def body(p, h):
            return _dense_block(cfg, p, h, positions, rope), None
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    for layer in unstack_tree(stack, count):
        if remat:
            x, a = checkpoint(lambda h, p=layer: body(p, h), x,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = body(layer, x)
        if a is not None:
            aux = aux + a
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = apply_lm_head(params["embed"], x)
    return logits, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Stable mean cross-entropy in fp32 plus ``z_loss * mean(lse^2)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - label_logit)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss


def train_loss_lm(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(total loss, {"ce_loss", "aux_loss"}) for a {"tokens", "labels"} batch."""
    logits, aux = forward_lm(params, batch["tokens"], cfg)
    loss = cross_entropy(logits, batch["labels"])
    total = loss + cfg.aux_loss_coef * aux
    return total, {"ce_loss": loss, "aux_loss": aux}
