"""Int8 per-channel quantization of serving weights and of cold KV pages
(the JAX package's ``serving/quantize.py``, in torch).

A quantized tensor is the dict ``{"q8": int8, "scale": fp32}`` with the
scale indexed by the channel axes; a quantized spectral group keeps its
``{"U", "s", "V"}`` shape with U/V replaced by quantized tensors and
``s`` left fp32. The fused kernel (``kernels/ops.py:spectral_matmul_q8``)
consumes the int8 factors directly: per-column scales commute with both
products, so ``u_scale * s * v_scale`` collapse into one k-length gain.
Dense ``w`` leaves dequantize at apply time (``nn/linear.py``).

Same rounding as the reference (``torch.round`` is round-half-to-even
like ``jnp.round``), the same clip to +-127, the same ``amax / 127``
scale floored at ``1e-12 / 127`` and the same axes, so codes and scales
equal the reference's on the same fp32 input.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.spectral import SPECTRAL_KEYS, is_spectral

# Subtrees never quantized (keyed by name in the parameter tree), the
# reference's list: the tied embedding / LM head (its logits decide the
# greedy token), MoE banks and the MLA up-projection (consumed raw), the
# encdec positional tables (sliced raw).
SKIP_KEYS = ("embed", "moe", "wukv", "enc_pos", "dec_pos")


def _quantize(w: torch.Tensor, axis: int) -> dict:
    """Symmetric int8 with the amax taken over ``axis``."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=axis)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
    return {"q8": q.to(torch.int8), "scale": scale.float()}


def _dequantize(qt: dict, axis: int, dtype: torch.dtype) -> torch.Tensor:
    return (qt["q8"].float() * qt["scale"].float().unsqueeze(axis)).to(dtype)


def quantize_int8(w: torch.Tensor) -> dict:
    """Per-channel int8 over the last axis, amax over axis -2 (the m/in
    axis of (..., m, k) factors and (..., in, out) dense weights);
    leading stacked layer axes broadcast. Reference:
    ``src/repro/serving/quantize.py:43``."""
    return _quantize(w, -2)


def dequantize_int8(qt: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``q8 * scale`` in fp32 (scale
    broadcast over axis -2), then cast to ``dtype``. Reference:
    ``src/repro/serving/quantize.py:55``."""
    return _dequantize(qt, -2, dtype)


def is_quantized(x: Any) -> bool:
    """One quantized tensor: a dict carrying ``q8`` and ``scale``."""
    return isinstance(x, dict) and "q8" in x and "scale" in x


def is_quantized_spectral(p: Any) -> bool:
    """A spectral group whose U and V are quantized tensors (``s``
    stays float). Reference: ``src/repro/serving/quantize.py:76``."""
    return (isinstance(p, dict) and set(p.keys()) >= set(SPECTRAL_KEYS)
            and is_quantized(p["U"]) and is_quantized(p["V"]))


def quantize_tree(params: Any, include_dense: bool = True) -> Any:
    """Spectral groups get int8 U/V (``s`` and bias pass through); dense
    ``w`` leaves of two or more axes get per-output-channel int8 when
    ``include_dense``; norms, biases and the ``SKIP_KEYS`` subtrees pass
    through untouched. Reference: ``src/repro/serving/quantize.py:89``."""

    def walk(tree):
        if is_spectral(tree):
            out = dict(tree)
            out["U"] = quantize_int8(tree["U"])
            out["V"] = quantize_int8(tree["V"])
            return out
        if isinstance(tree, dict):
            out = {}
            for key, val in tree.items():
                if key in SKIP_KEYS:
                    out[key] = val
                elif (include_dense and key == "w" and isinstance(val, torch.Tensor)
                      and val.ndim >= 2):
                    out[key] = quantize_int8(val)
                else:
                    out[key] = walk(val)
            return out
        return tree

    return walk(params)


def dequantize_tree(params: Any, dtype: torch.dtype = torch.float32) -> Any:
    """Every quantized tensor back to floating point (the reference
    CLI's ``--verify`` oracle). Reference:
    ``src/repro/serving/quantize.py:119``."""

    def walk(tree):
        if is_quantized(tree):
            return dequantize_int8(tree, dtype)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(params)


def quantize_kv_pages(vals: torch.Tensor, token_axis: int = 1) -> dict:
    """Page-granular int8 for cold KV pages: the amax is taken over the
    token axis, so every other (layer, head, feature) channel keeps its
    own scale. GQA pages ``(L, page, kvh, hd)`` give scales
    ``(L, kvh, hd)``. Reference: ``src/repro/serving/quantize.py:136``."""
    return _quantize(vals, token_axis)


def dequantize_kv_pages(qt: dict, token_axis: int = 1,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages`. Reference:
    ``src/repro/serving/quantize.py:153``."""
    return _dequantize(qt, token_axis, dtype)


def param_bytes(params: Any) -> int:
    """Bytes held by a parameter tree (int8 leaves count one byte an
    element). Reference: ``src/repro/serving/quantize.py:162``."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
