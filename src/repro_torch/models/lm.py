"""Decoder-only language model, the ``dense_lm`` family (llama3.2-1b,
granite-3-2b, qwen1.5, smollm2, llama-70b-sct): token embedding,
RMSNorm, GQA attention with RoPE, a SwiGLU MLP whose projections are
spectral, the tied LM head.

Parameters keep the reference's layer-stacked layout — every leaf under
``layers`` carries a leading ``n_layers`` axis (``layers/mlp/up/U`` is
``(L, m, k)``) — so an npz checkpoint maps onto them key for key. The
layer loop is a Python loop over views of those stacks; with
``cfg.remat`` each layer body is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``). The other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.model_config import ModelConfig
from repro_torch.core.tree import stack_trees, unstack_tree
from repro_torch.device import compute_dtype
from repro_torch.nn import attention as attn
from repro_torch.nn.embedding import apply_embedding, apply_lm_head, init_embedding
from repro_torch.nn.mlp import apply_mlp, init_mlp
from repro_torch.nn.norms import apply_rmsnorm, init_rmsnorm

Params = Dict[str, Any]


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense_lm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port runs dense_lm)")
    if cfg.attention != "gqa" or cfg.norm != "rmsnorm":
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


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: torch.device) -> Params:
    """fp32 master parameters in the reference's layout."""
    require_dense(cfg)
    params: Params = {
        "embed": init_embedding(cfg.vocab, cfg.d_model, generator=generator, device=device)}
    params["layers"] = stack_trees(
        [_init_dense_layer(cfg, generator, device) for _ in range(cfg.n_layers)])
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=device)
    return params


def _dense_block(cfg, p, x, positions, rope=None):
    h = _norm_apply(cfg, p["attn_norm"], x)
    x = x + attn.apply_gqa(p["attn"], h, cfg, positions=positions, rope=rope)
    h = _norm_apply(cfg, p["mlp_norm"], x)
    return x + apply_mlp(p["mlp"], h, act=cfg.act)


def forward_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (b, s) -> (logits (b, s, vocab), aux_loss 0.0)."""
    require_dense(cfg)
    b, s = tokens.shape
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = attn.step_rope(cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    for layer in unstack_tree(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(lambda h, p=layer: _dense_block(cfg, p, h, positions, rope), x,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dense_block(cfg, layer, x, positions, rope)
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = apply_lm_head(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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
