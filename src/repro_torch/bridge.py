"""The weight bridge: the JAX package's parameters (numpy arrays in its
pytree / npz layout) into the port's, and the ``nn.Module`` view of a
parameter tree.

Both packages keep the same layer-stacked layout, so the mapping is
one-to-one: npz key ``layers/mlp/up/U`` is the tree path
``params["layers"]["mlp"]["up"]["U"]`` and the module parameter
``layers.mlp.up.U``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.store import flatten, load_pytree, to_tensor, unflatten
from repro_torch.config.model_config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import init_lm


def expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """npz key -> shape of the port's parameters for ``cfg`` (built on
    the meta device: no memory, no arithmetic)."""
    meta = init_lm(cfg, generator=torch.Generator(), device=torch.device("meta"))
    return {k: tuple(v.shape) for k, v in flatten(meta).items()}


def params_from_numpy(tree_or_flat_npz, cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """JAX-package parameters -> the port's parameter tree on ``device``.

    Accepts a nested dict of arrays (e.g. ``jax.device_get(params)``), a
    flat ``{"a/b/c": array}`` mapping (an opened npz), or the path of an
    npz the JAX package's ``save_pytree`` wrote. Keys and shapes are
    checked against ``cfg``; values are copied (the port's caches and
    any later in-place update never alias the caller's arrays)."""
    src = tree_or_flat_npz
    if isinstance(src, (str, os.PathLike)):
        src = load_pytree(os.fspath(src))
    if isinstance(src, Mapping) and any("/" in k for k in src.keys()):
        src = unflatten(src)
    flat = flatten(src)
    want = expected_shapes(cfg)
    if set(flat) != set(want):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"parameter keys do not match {cfg.name}: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    dev = resolve_device(device)
    out = {}
    for key, leaf in flat.items():
        arr = np.asarray(leaf)
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, expected {want[key]}")
        out[key] = to_tensor(arr, dev)
    return unflatten(out)


class ParamTree(nn.Module):
    """``nn.Module`` over a parameter tree: sub-dicts become submodules,
    leaves become parameters, so ``named_parameters()`` yields the npz
    keys with ``.`` for ``/``. :meth:`tree` returns the nested dict the
    model functions take, sharing storage with the module."""

    def __init__(self, tree: Dict[str, Any], requires_grad: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, requires_grad))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=requires_grad))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_module(params: Dict[str, Any], requires_grad: bool = False) -> ParamTree:
    return ParamTree(params, requires_grad)
