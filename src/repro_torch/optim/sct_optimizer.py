"""The SCT training step as an optimizer wrapper (the reference's
``optim/sct_optimizer.py``, its unscaled branch): AdamW on every
parameter, then the Stiefel retraction of every spectral U/V (paper
Algorithm 1), every ``retract_every`` steps.

The state is the reference's TrainState layout
``{"params", "opt": {"mu", "nu", "count"}, "step"}`` (``step`` an int32
0-d tensor), so a checkpoint of either package restores in the other.
Loss scaling (the reference's ``mixed`` policy) and rank resizing are
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core.precision import PrecisionPolicy, precision_policy
from repro_torch.core.tree import retract_tree, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import ScheduleConfig, make_schedule

TrainState = dict  # {"params", "opt", "step"}


@dataclasses.dataclass(frozen=True)
class SCTOptimizer:
    adamw: AdamWConfig
    schedule: ScheduleConfig
    retraction: str = "qr"
    retract_every: int = 1
    clip_norm: float = 1.0
    precision: Optional[PrecisionPolicy] = None  # None -> legacy

    def init(self, params: Any) -> TrainState:
        if self.precision is not None:
            dt = self.precision.param_torch
            params = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, params)
        opt = adamw_init(params, self.adamw.moment_dtype)
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32, device=opt["count"].device)}

    def _update(self, params: Any, opt: Any, step: int, grads: Any):
        """One AdamW step and, on the cadence, the retraction. ``step``
        is the pre-increment counter: the schedule reads it, the
        retraction cadence checks step + 1."""
        lr_t = make_schedule(self.schedule)(step)
        if self.clip_norm:
            grads, _ = clip_by_global_norm(grads, self.clip_norm)
        params, opt = adamw_update(params, grads, opt, self.adamw, lr_t)
        if (step + 1) % self.retract_every == 0:
            params = retract_tree(params, self.retraction)
        return params, opt

    def apply(self, state: TrainState, grads: Any) -> TrainState:
        """The state after one step on ``grads``. The fp32 parameters, the
        moments and ``grads`` are updated in place (the same bits as the
        functional update; the reference's jit donates these buffers), so
        ``state`` is spent: keep a copy to hold on to the old one."""
        with torch.no_grad():
            params, opt = self._update(state["params"], state["opt"],
                                       int(state["step"]), grads)
        out = dict(state)
        out.update(params=params, opt=opt, step=state["step"] + 1)
        return out

    def resize(self, *args, **kwargs):
        raise NotImplementedError("rank resizing (rank/resize.py) is not ported")


def make_sct_optimizer(
    model_cfg=None,
    *,
    lr: float = 5e-4,
    warmup: int = 100,
    total_steps: int = 2000,
    clip_norm: float = 1.0,
    spectral_lr_scale: float = 1.0,
    dense_lr_scale: float = 1.0,
    weight_decay: float = 0.01,
    precision: Union[str, PrecisionPolicy, None] = None,
) -> SCTOptimizer:
    retraction = model_cfg.sct.retraction if model_cfg is not None else "qr"
    retract_every = model_cfg.sct.retract_every if model_cfg is not None else 1
    return SCTOptimizer(
        adamw=AdamWConfig(lr=lr, weight_decay=weight_decay,
                          spectral_lr_scale=spectral_lr_scale,
                          dense_lr_scale=dense_lr_scale),
        schedule=ScheduleConfig(peak_lr=lr, warmup_steps=warmup, total_steps=total_steps),
        retraction=retraction,
        retract_every=retract_every,
        clip_norm=clip_norm,
        precision=precision_policy(precision),
    )
