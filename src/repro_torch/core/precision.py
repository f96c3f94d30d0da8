"""Precision policy (the reference's ``core/precision.py``): param /
compute / accum dtypes plus dynamic loss scaling with overflow skip.

  legacy — compute in ``ModelConfig.dtype``, fp32 accumulation, no loss
           scaling, parameters stored as ``init_model`` made them (fp32
           masters): bf16 compute over fp32 masters for the bf16 configs.
  fp32   — everything fp32 (the paper's setting).
  bf16   — bf16 factors and bf16 compute: the memory-minimal mode; the
           retraction of bf16-stored factors is orthonormal only to
           bf16's rounding.
  mixed  — fp32 masters (parameters and Adam moments), bf16 compute, the
           loss multiplied by a dynamic scale and the gradients unscaled
           before the update; a step whose unscaled gradients hold an inf
           or a nan is skipped (parameters, moments and retraction
           untouched) and the scale backs off.

The loss-scale state is ``{"scale": fp32, "good_steps": int32,
"skipped": int32}`` 0-d tensors inside the train state, the reference's
checkpoint layout, so a restart restores the schedule bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.tree import tree_leaves, tree_map

LEGACY = "legacy"


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Storage dtype of params/masters (``param_dtype``), the
    forward/backward activation dtype (``compute_dtype``), the microbatch
    gradient-accumulation dtype (``accum_dtype``), and the dynamic
    loss-scaling constants used when ``loss_scaling`` is on."""
    name: str = "fp32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    loss_scaling: bool = False
    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000       # finite steps between scale doublings
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    @property
    def param_torch(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def accum_torch(self) -> torch.dtype:
        return getattr(torch, self.accum_dtype)


POLICIES: Dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy(),
    "bf16": PrecisionPolicy(name="bf16", param_dtype="bfloat16", compute_dtype="bfloat16"),
    "mixed": PrecisionPolicy(name="mixed", compute_dtype="bfloat16", loss_scaling=True),
}


def precision_policy(policy: Union[str, PrecisionPolicy, None]) -> Optional[PrecisionPolicy]:
    """Resolve a policy by name ('legacy' | 'fp32' | 'bf16' | 'mixed') or
    pass a PrecisionPolicy through; None and 'legacy' both mean the
    legacy mode, for which the optimizer-facing policy is None."""
    if policy is None or isinstance(policy, PrecisionPolicy):
        return policy
    if policy == LEGACY:
        return None
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown precision {policy!r}; options "
                         f"{[LEGACY, *POLICIES]}") from None


def effective_policy(cfg, policy: Union[str, PrecisionPolicy, None]) -> PrecisionPolicy:
    """The resolved contract for a (config, policy) pair: legacy resolves
    to ``cfg.dtype`` compute over the stored (fp32) parameters, fp32
    accumulation and no scaling."""
    pol = precision_policy(policy)
    if pol is not None:
        return pol
    return PrecisionPolicy(name=LEGACY, compute_dtype=cfg.dtype)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point leaf; integer leaves (step counters,
    token ids) pass through untouched."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


# ----------------------------------------------------------------- loss scale

LossScaleState = Dict[str, torch.Tensor]   # {"scale", "good_steps", "skipped"}


def loss_scale_init(policy: PrecisionPolicy, device=None) -> LossScaleState:
    """Fresh loss-scale state: ``scale`` fp32 (``init_scale``),
    ``good_steps`` and ``skipped`` int32, all 0-d on ``device``;
    ``skipped`` is the lifetime count of overflow-skipped steps."""
    return {"scale": torch.tensor(policy.init_scale, dtype=torch.float32, device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device),
            "skipped": torch.zeros((), dtype=torch.int32, device=device)}


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating-point leaf of the tree is finite.
    One reduction a leaf, combined on the device: reading the answer is
    the step's one host read, not one a leaf. Integer leaves are ignored;
    a tree without floating leaves is vacuously finite."""
    flags = [torch.isfinite(t).all() for t in tree_leaves(tree) if t.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def loss_scale_update(state: LossScaleState, finite: Union[torch.Tensor, bool],
                      policy: PrecisionPolicy) -> LossScaleState:
    """Dynamic loss-scale schedule: after ``growth_interval`` consecutive
    finite steps the scale doubles (capped at ``max_scale``); an overflow
    halves it (floored at ``min_scale``) and resets the streak. New
    tensors: the given state is left as it is."""
    scale = state["scale"]
    finite = torch.as_tensor(finite, device=scale.device)
    good = state["good_steps"] + 1
    grow = good >= policy.growth_interval
    grown = torch.minimum(scale * policy.growth_factor,
                          torch.tensor(policy.max_scale, dtype=torch.float32, device=scale.device))
    scale_ok = torch.where(grow, grown, scale)
    good_ok = torch.where(grow, torch.zeros_like(good), good)
    scale_bad = torch.maximum(scale * policy.backoff_factor,
                              torch.tensor(policy.min_scale, dtype=torch.float32,
                                           device=scale.device))
    return {"scale": torch.where(finite, scale_ok, scale_bad).to(torch.float32),
            "good_steps": torch.where(finite, good_ok, torch.zeros_like(good)).to(torch.int32),
            "skipped": (state["skipped"] + (~finite).to(torch.int32)).to(torch.int32)}


def scale_loss(loss: torch.Tensor, state: Optional[LossScaleState]) -> torch.Tensor:
    """The loss times the current dynamic scale before differentiation;
    the identity when ``state`` is None (a state without a loss scale).
    The scale is a power of two: dividing the reported loss back is
    exact."""
    return loss if state is None else loss * state["scale"].to(loss.dtype)


def unscale_grads(grads: Any, state: LossScaleState) -> Any:
    """Scaled gradients divided back down, in fp32 (the reference's
    ``g.astype(f32) * (1 / scale)``). fp32 gradients are scaled in place:
    the scale is a power of two, so ``g * inv`` has the bits of the
    functional product. Others come back as new fp32 tensors."""
    inv = 1.0 / state["scale"]

    def unscale(g):
        if g.dtype == torch.float32:
            return g.mul_(inv)
        return g.to(torch.float32) * inv

    return tree_map(unscale, grads)
