"""Precision policy (the reference's ``core/precision.py``, the modes
without loss scaling).

  legacy — compute in ``ModelConfig.dtype``, fp32 accumulation, no loss
           scaling, parameters stored as ``init_model`` made them (fp32
           masters): bf16 compute over fp32 masters for the bf16 configs.
  fp32   — everything fp32 (the paper's setting).

The reference's ``bf16`` and ``mixed`` presets, with dynamic loss
scaling and overflow skip, are not ported: asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

LEGACY = "legacy"
UNPORTED = ("bf16", "mixed")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Storage dtype of params/masters and the forward/backward
    activation dtype (gradients accumulate in fp32; no loss scaling)."""
    name: str = "fp32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def param_torch(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


POLICIES: Dict[str, PrecisionPolicy] = {"fp32": PrecisionPolicy()}


def precision_policy(policy: Union[str, PrecisionPolicy, None]) -> Optional[PrecisionPolicy]:
    """Resolve a policy by name; None and 'legacy' both mean the legacy
    mode, for which the optimizer-facing policy is None."""
    if policy is None or isinstance(policy, PrecisionPolicy):
        return policy
    if policy == LEGACY:
        return None
    if policy in UNPORTED:
        raise NotImplementedError(
            f"precision {policy!r} (loss scaling / bf16 masters) is not ported; "
            f"options {[LEGACY, *POLICIES]}")
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown precision {policy!r}; options "
                         f"{[LEGACY, *POLICIES, *UNPORTED]}") from None


def effective_policy(cfg, policy: Union[str, PrecisionPolicy, None]) -> PrecisionPolicy:
    """The resolved contract for a (config, policy) pair: legacy resolves
    to ``cfg.dtype`` compute over the stored (fp32) parameters."""
    pol = precision_policy(policy)
    if pol is not None:
        return pol
    return PrecisionPolicy(name=LEGACY, compute_dtype=cfg.dtype)
