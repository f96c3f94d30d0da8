"""The SCT training step as an optimizer wrapper (the reference's
``optim/sct_optimizer.py``): AdamW on every parameter, then the Stiefel
retraction of every spectral U/V (paper Algorithm 1), every
``retract_every`` steps.

The state is the reference's TrainState layout
``{"params", "opt": {"mu", "nu", "count"}, "step"[, "loss_scale"]}``
(``step`` an int32 0-d tensor), so a checkpoint of either package
restores in the other. Under a loss-scaling policy (``mixed``) the state
carries ``loss_scale`` and ``apply`` takes scaled gradients: it unscales
them, decides on the device whether they are all finite (one host read),
and only then clips, updates and retracts; an overflowed step leaves
parameters, moments and factors as they were, bit for bit, halves the
scale and counts the skip. Master parameters are stored in the policy's
``param_dtype``. Rank resizing is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core.precision import (
    PrecisionPolicy,
    all_finite,
    cast_tree,
    loss_scale_init,
    loss_scale_update,
    precision_policy,
    unscale_grads,
)
from repro_torch.core.tree import retract_tree
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import ScheduleConfig, make_schedule

TrainState = dict  # {"params", "opt", "step"[, "loss_scale"]}


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
            params = cast_tree(params, self.precision.param_torch)
        opt = adamw_init(params, self.adamw.moment_dtype)
        device = opt["count"].device
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        if self.precision is not None and self.precision.loss_scaling:
            state["loss_scale"] = loss_scale_init(self.precision, device)
        return state

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
        ``state`` is spent: keep a copy to hold on to the old one.

        Gradients are taken as scaled only when the policy scales AND the
        state has ``loss_scale`` (as the step builder decides whether to
        scale), so a state written under another policy trains unscaled
        on both sides. The step counter advances on a skip too."""
        pol = self.precision
        step = int(state["step"])
        out = dict(state)
        with torch.no_grad():
            if pol is None or not pol.loss_scaling or "loss_scale" not in state:
                params, opt = self._update(state["params"], state["opt"], step, grads)
            else:
                ls = state["loss_scale"]
                # unscale, then decide, and only then clip and update in place;
                # the ranges name the loss-scale work in a profile
                with torch.profiler.record_function("loss_scale.unscale"):
                    grads = unscale_grads(grads, ls)
                with torch.profiler.record_function("loss_scale.all_finite"):
                    finite = all_finite(grads)
                    ok = bool(finite)
                if ok:
                    params, opt = self._update(state["params"], state["opt"], step, grads)
                else:
                    params, opt = state["params"], state["opt"]
                out["loss_scale"] = loss_scale_update(ls, finite, pol)
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
