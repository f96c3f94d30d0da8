"""Decoder-only language models of two families:

  dense_lm — llama3.2-1b, granite-3-2b, qwen1.5, smollm2, llama-70b-sct:
             token embedding, RMSNorm, GQA attention with RoPE, a SwiGLU
             MLP whose projections are spectral, the tied LM head;
  ssm_lm   — xlstm-1.3b: periods of ``slstm_every`` blocks, the sLSTM at
             ``slstm_offset`` and mLSTMs elsewhere (nn/xlstm.py), each
             block pre-normed with a residual.

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
from repro_torch.nn import xlstm as xlstm_mod
from repro_torch.nn.embedding import apply_embedding, apply_lm_head, init_embedding
from repro_torch.nn.mlp import apply_mlp, init_mlp
from repro_torch.nn.norms import apply_rmsnorm, init_rmsnorm

Params = Dict[str, Any]


# what the port runs, by family: parameter init and the forward (with its
# loss value), serving (prefill and decode), training (gradients)
SUPPORT = {"dense_lm": ("init", "forward", "serve", "train"),
           "ssm_lm": ("init", "forward", "serve")}


def require_family(cfg: ModelConfig, path: str) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``path`` (one of
    init, forward, serve, train) for ``cfg``'s family."""
    if path not in SUPPORT.get(cfg.family, ()):
        if cfg.family == "ssm_lm" and path == "train":
            raise NotImplementedError(
                "training the ssm_lm family is the next slice of the port: it needs "
                "hand-written backward kernels for the mLSTM chunk and the sLSTM scan")
        ported = ", ".join(f"{fam} ({'/'.join(paths)})" for fam, paths in SUPPORT.items())
        raise NotImplementedError(f"family {cfg.family!r}: {path} is not ported yet "
                                  f"(the port runs {ported})")
    if cfg.norm != "rmsnorm" or (cfg.family == "dense_lm" and cfg.attention != "gqa"):
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


def n_periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.slstm_every


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: torch.device) -> Params:
    """fp32 master parameters in the reference's layout."""
    require_family(cfg, "init")
    params: Params = {
        "embed": init_embedding(cfg.vocab, cfg.d_model, generator=generator, device=device)}
    if cfg.family == "ssm_lm":
        params["periods"] = stack_trees(
            [_init_xlstm_period(cfg, generator, device) for _ in range(n_periods(cfg))])
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
    """tokens (b, s) -> (logits (b, s, vocab), aux_loss 0.0)."""
    require_family(cfg, "forward")
    b, s = tokens.shape
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    if cfg.family == "ssm_lm":
        stack, count = params["periods"], n_periods(cfg)

        def body(p, h):
            return _xlstm_period_fwd(cfg, p, h)
    else:
        stack, count = params["layers"], cfg.n_layers
        positions = torch.arange(s, device=x.device).expand(b, s)
        rope = attn.step_rope(cfg, positions)

        def body(p, h):
            return _dense_block(cfg, p, h, positions, rope)
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    for layer in unstack_tree(stack, count):
        if remat:
            x = checkpoint(lambda h, p=layer: body(p, h), x,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(layer, x)
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
