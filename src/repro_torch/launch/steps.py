"""The train step builder (the reference's ``launch/steps.py``
``make_train_step``, without rank telemetry): forward and backward
through the model's loss, microbatched with fp32 gradient accumulation
when asked, under the optimizer's precision policy, then the SCT
optimizer's update."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.store import flatten, unflatten
from repro_torch.config.model_config import ModelConfig
from repro_torch.core.precision import effective_policy, scale_loss
from repro_torch.models.lm import require_family
from repro_torch.models.model import train_loss
from repro_torch.optim import SCTOptimizer, make_sct_optimizer


def make_train_step(cfg: ModelConfig, optimizer: Optional[SCTOptimizer] = None,
                    microbatches: int = 1, telemetry: bool = False):
    """(state, batch) -> (state, metrics). The optimizer's precision
    policy sets the forward's compute dtype (legacy: ``cfg.dtype`` over
    the fp32 masters). Metrics are 0-d tensors: ``loss``, ``ce_loss``,
    ``aux_loss`` (the MoE's load-balance loss of the hybrid and moe_lm
    families, summed over the MoE layers; 0 for the others). The step
    consumes the state it is given: its parameters and AdamW moments are
    updated in place and the returned state holds the same tensors, so an
    earlier state is kept only as a copy.

    ``microbatches`` > 1 splits every batch entry along dim 0 into that
    many equal slices and takes each slice's gradients in turn, adding
    them into a zero tree in the policy's ``accum_dtype`` (fp32) and
    dividing by the count, the reference's order; the loss and every
    metric are the slices' mean. Under loss scaling (the policy scales and
    the state has ``loss_scale``) each slice's loss is multiplied by the
    scale before differentiation, and the metrics add the unscaled
    ``loss`` (exact: the scale is a power of two), ``loss_scale`` and
    ``overflow`` (1.0 where the step was skipped). Rank telemetry is not
    ported.

    The port trains every family it runs (``models/lm.py:SUPPORT``):
    dense_lm, ssm_lm (xlstm, whose mLSTM layers run the chunkwise kernel
    and its hand-written backward), hybrid (jamba, whose mamba layers run
    the selective-scan kernel and its hand-written backward) and moe_lm
    (deepseek, whose MLA layers run the flash kernels at q/k width 192
    and v width 128). The MoE sizes its capacity per forward, so a
    microbatched MoE step is not the full batch's step."""
    require_family(cfg, "train")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if telemetry:
        raise NotImplementedError("rank telemetry (rank/telemetry.py) is not ported")
    opt = optimizer or make_sct_optimizer(cfg)
    pol = effective_policy(cfg, opt.precision)
    cfg_eff = cfg.replace(dtype=pol.compute_dtype)

    def grads_of(leaves, batch, ls):
        """(loss, metrics, gradient per leaf) of one (micro)batch; the
        loss is scaled when ``ls`` is a loss-scale state."""
        with torch.enable_grad():
            loss, metrics = train_loss(unflatten(leaves), batch, cfg_eff)
            loss = scale_loss(loss, ls)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves.values(), grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state, batch):
        # scaling needs the policy AND the state's entry, as opt.apply decides
        scaling = pol.loss_scaling and "loss_scale" in state
        ls = state["loss_scale"] if scaling else None
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in flatten(state["params"]).items()}
        if microbatches == 1:
            loss, metrics, grads = grads_of(leaves, batch, ls)
        else:
            sizes = {v.shape[0] for v in batch.values()}
            if len(sizes) != 1 or next(iter(sizes)) % microbatches:
                raise ValueError(f"batch of {sorted(sizes)} rows does not split into "
                                 f"{microbatches} equal microbatches")
            rows = next(iter(sizes)) // microbatches
            grads = [torch.zeros(t.shape, dtype=pol.accum_torch, device=t.device)
                     for t in leaves.values()]
            losses, mets = [], []
            for i in range(microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, met, g = grads_of(leaves, mb, ls)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                losses.append(l)
                mets.append(met)
            for acc in grads:
                acc.div_(microbatches)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        grads = unflatten(dict(zip(leaves, grads)))
        del leaves
        new_state = opt.apply(state, grads)     # its loss_scale is new tensors: ls stays
        metrics = dict(metrics)
        if scaling:
            metrics["loss"] = loss / ls["scale"]
            metrics["loss_scale"] = ls["scale"]
            metrics["overflow"] = (new_state["loss_scale"]["skipped"]
                                   > ls["skipped"]).to(torch.float32)
        else:
            metrics["loss"] = loss
        return new_state, metrics

    return train_step
