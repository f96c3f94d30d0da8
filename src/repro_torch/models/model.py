"""Model dispatcher: one API over the ported families (``dense_lm``,
``ssm_lm``, ``hybrid`` and ``moe_lm`` for init, forward, serving and
training — ``models/lm.py:SUPPORT``).

  init_model(cfg, seed=, device=)                 -> params
  forward(params, tokens, cfg)                    -> (logits, aux)
  train_loss(params, batch, cfg)                  -> (loss, metrics)
  init_decode_state / prefill / decode_step       (static cache)
  init_paged_state / decode_step_paged / prefill_chunk_paged
  serving_params(params, cfg, device, quantize=)  -> params quantized / cast once

Params are nested dicts of tensors in the reference's layout;
``bridge.as_module`` wraps them in an ``nn.Module`` whose parameter
names are the npz keys with ``.`` for ``/``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.model_config import ModelConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.device import DeviceLike, compute_dtype, generator_for, resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import lm as lm_mod
from repro_torch.serving.quantize import is_quantized, param_bytes, quantize_tree


def init_model(cfg: ModelConfig, *, seed: int = 0,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None):
    """Random fp32 master parameters from a seeded generator on
    ``device`` (the CUDA device unless told otherwise). Same
    distributions as the reference's init; other draws."""
    dev = resolve_device(device)
    return lm_mod.init_lm(cfg, generator=generator_for(dev, seed, generator), device=dev)


def forward(params, tokens, cfg: ModelConfig):
    return lm_mod.forward_lm(params, tokens, cfg)


def train_loss(params, batch, cfg: ModelConfig):
    return lm_mod.train_loss_lm(params, batch, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *, device):
    return decode_mod.lm_init_state(cfg, batch, max_seq, device=device)


def prefill(params, tokens, cfg: ModelConfig, state):
    return decode_mod.prefill_lm(params, tokens, cfg, state)


def decode_step(params, tokens, state, cache_len: int, cfg: ModelConfig):
    return decode_mod.decode_step_lm(params, tokens, state, cache_len, cfg)


def init_paged_state(cfg: ModelConfig, pcfg, *, device, cold_kv: str = "none"):
    return decode_mod.lm_init_paged_state(cfg, pcfg, device=device, cold_kv=cold_kv)


def decode_step_paged(params, tokens, state, block_table, seq_lens, cfg: ModelConfig, *,
                      cold_flags=None):
    return decode_mod.decode_step_lm_paged(params, tokens, state, block_table,
                                           seq_lens, cfg, cold_flags=cold_flags)


def prefill_chunk_paged(params, tokens, state, block_table, start: int, cfg: ModelConfig,
                        *, cold_flags=None):
    return decode_mod.prefill_chunk_lm_paged(params, tokens, state, block_table,
                                             start, cfg, cold_flags=cold_flags)


# leaves serving keeps in fp32 whatever the compute dtype: by leaf name,
# and by the last two keys of the leaf's path
FP32_LEAVES = ("s", "wr", "A_log")
FP32_PATHS = (("wukv", "w"),)


def serving_params(params, cfg: ModelConfig, device: torch.device,
                   quantize: Optional[str] = None):
    """Params on ``device`` as the engine serves them: with
    ``quantize="int8"`` the fp32 masters are quantized first
    (``serving/quantize.py:quantize_tree``, as the reference engine does
    at ``src/repro/serving/engine.py:112-117``); then every remaining
    floating leaf is cast once to the compute dtype, except the spectral
    ``s`` vectors (the kernels scale h by s in fp32), the sLSTM's
    recurrent ``wr`` (the reference casts it to the fp32 state's dtype,
    ``src/repro/nn/xlstm.py:225``), mamba's ``A_log`` (the reference
    takes ``-exp`` of it in fp32 at every call, ``src/repro/nn/mamba.py:91``:
    a bf16 copy would give another A), MLA's up-projection ``wukv/w`` (the
    absorbed decode reads it as fp32 W_uk and W_uv,
    ``src/repro/nn/attention.py:678-684``: a bf16 copy would give another
    q_lat; the prefill paths cast it to the compute dtype at each use, as
    the reference does) and the leaves of a quantized tensor
    (``q8`` stays int8, ``scale`` fp32). A tree that is
    already quantized passes through with its codes and scales as they
    are. The reference casts at every apply, which gives the same
    numbers; casting once keeps the 128k-row embedding/LM-head table out
    of every decode step's bytes."""
    if quantize == "int8":
        params = quantize_tree(params)
    elif quantize is not None:
        raise ValueError(f"unknown quantization {quantize!r}; options: int8")
    dt = compute_dtype(cfg)

    def walk(tree, parent=None):
        if is_quantized(tree):
            return {"q8": tree["q8"].to(device), "scale": tree["scale"].to(device).float()}
        return {k: walk(v, k) if isinstance(v, dict) else cast((parent, k), v)
                for k, v in tree.items()}

    def cast(path, t):
        t = t.to(device)
        if t.is_floating_point() and path[1] not in FP32_LEAVES and path not in FP32_PATHS:
            t = t.to(dt)
        return t

    return walk(params)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


__all__ = [
    "init_model", "forward", "train_loss", "init_decode_state", "prefill", "decode_step",
    "init_paged_state", "decode_step_paged", "prefill_chunk_paged",
    "serving_params", "param_count", "param_bytes",
]
