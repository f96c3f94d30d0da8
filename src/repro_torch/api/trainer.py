"""Trainer: the training facade over one :class:`RunSpec` (the
reference's ``api/trainer.py`` on one device).

  * :meth:`fit` — the checkpointed loop to ``spec.train.steps``
    (``runtime/train_loop.py``); sidecars embed the serialized RunSpec;
  * :meth:`step` — one optimizer step at a time, no checkpoint directory
    needed;
  * :meth:`resume` — a Trainer rebuilt from the spec embedded in the
    newest checkpoint under a directory, whichever package wrote it.

The run is on the CUDA device unless the caller passes ``device="cpu"``
(without a GPU and without a device it raises). Every precision mode and
microbatching are ported; rank schedules and telemetry raise.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.api.specs import RunSpec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import to_tensor
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_model
from repro_torch.optim import make_sct_optimizer
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

__all__ = ["Trainer", "log_metrics"]


def log_metrics(step: int, metrics: Dict[str, float]) -> None:
    """The CLI's train-log line: the loss, its cross-entropy, its MoE
    load-balance part (``aux``, 0 for a family without an MoE) and, under
    loss scaling, the scale."""
    line = (f"step {step:6d}  loss {metrics['loss']:.4f}  ce {metrics['ce_loss']:.4f}  "
            f"aux {metrics.get('aux_loss', 0.0):.4f}")
    if "loss_scale" in metrics:
        line += f"  scale {metrics['loss_scale']:.0f}"
    print(line, flush=True)


class Trainer:
    """One training run, described by ``spec``, on ``device``.
    ``metrics_cb(step, {name: float})`` fires every ``log_every`` steps of
    :meth:`fit`. Parameters materialize on the first :meth:`fit` /
    :meth:`step` / :meth:`save`. Each step updates the state's parameters
    and moments in place (``make_train_step``): :attr:`state` returns
    the live tensors, which later steps change. ``failure_hook(step)`` is
    the loop's chaos-drill injection point (:meth:`fit`)."""

    def __init__(self, spec: RunSpec, *, device: DeviceLike = None,
                 metrics_cb: Optional[Callable[[int, Dict], None]] = None,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg = spec.model.config()
        t = spec.train
        self.optimizer = make_sct_optimizer(
            self.cfg, lr=t.lr, warmup=t.warmup_steps, total_steps=t.steps,
            precision=spec.precision.mode)
        self._step_fn = make_train_step(self.cfg, self.optimizer,
                                        microbatches=t.microbatches, telemetry=t.telemetry)
        self.metrics_cb = metrics_cb
        self.failure_hook = failure_hook
        self.dataset = SyntheticLMDataset(vocab=self.cfg.vocab, seq_len=t.seq, seed=t.seed)
        self.manager: Optional[CheckpointManager] = None
        if spec.checkpoint.directory is not None:
            self.manager = CheckpointManager(spec.checkpoint.directory,
                                             keep=spec.checkpoint.keep,
                                             run_spec=spec.to_dict())
        self.loop: Optional[TrainLoop] = None
        self._state: Any = None
        self._step = 0
        self._batches = None

    # ---------------------------------------------------------------- data --
    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The spec's synthetic batch for ``step``, on the device."""
        tokens, labels = self.dataset.batch(step, self.spec.train.batch)
        return {"tokens": torch.as_tensor(tokens, device=self.device),
                "labels": torch.as_tensor(labels, device=self.device)}

    def _batch_iter(self, start_step: int):
        step = start_step
        while True:
            yield self.make_batch(step)
            step += 1

    def _init_state(self):
        params = init_model(self.cfg, seed=self.spec.train.seed, device=self.device)
        return self.optimizer.init(params)

    def _place(self, state):
        """A restored tree of numpy arrays as the device state."""
        return tree_map(lambda a: to_tensor(a, self.device), state)

    # ----------------------------------------------------------------- fit --
    def fit(self) -> Any:
        """Run the checkpointed loop to ``spec.train.steps`` and return the
        final state; resumes from the newest checkpoint under
        ``spec.checkpoint.directory``, which is required."""
        if self.manager is None:
            raise ValueError("Trainer.fit needs spec.checkpoint.directory; drive the "
                             "run with Trainer.step() instead")
        if self._state is not None:
            # progress made with step() lands on disk first, or the loop
            # would re-run it from the last checkpoint
            self.manager.wait()
            latest = self.manager.list_steps()
            if self._step > (latest[-1] if latest else -1):
                self.manager.save(self._step, self._state, block=True)
        self.loop = TrainLoop(
            step_fn=self._step_fn,
            batch_iter_factory=self._batch_iter,
            ckpt_dir=self.spec.checkpoint.directory,
            cfg=TrainLoopConfig(total_steps=self.spec.train.steps,
                                checkpoint_every=self.spec.checkpoint.every,
                                keep_checkpoints=self.spec.checkpoint.keep),
            init_state_fn=self._init_state,
            place_state_fn=self._place,
            metrics_cb=self.metrics_cb,
            failure_hook=self.failure_hook,
            checkpoint_manager=self.manager,
        )
        self._state = self.loop.run()
        self._step = int(self._state["step"])
        self._batches = self._batch_iter(self._step)
        return self._state

    # ---------------------------------------------------------------- step --
    def _ensure_state(self) -> None:
        if self._state is not None:
            return
        step, state = (self.manager.restore_latest() if self.manager is not None
                       else (None, None))
        if state is None:
            step, state = 0, self._init_state()
        else:
            state = self._place(state)
        self._state, self._step = state, step
        self._batches = self._batch_iter(step)

    def step(self, batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns its metrics (0-d tensors). The first
        call restores the newest checkpoint when a directory is set, else
        initializes from ``spec.train.seed``; ``batch`` defaults to the
        synthetic stream at the current step."""
        self._ensure_state()
        if batch is None:
            batch = next(self._batches)
        self._state, metrics = self._step_fn(self._state, batch)
        self._step += 1
        return metrics

    # ---------------------------------------------------------------- save --
    def save(self) -> int:
        """Checkpoint the current state at the current step, written
        before this returns; returns the step."""
        if self.manager is None:
            raise ValueError("Trainer.save needs spec.checkpoint.directory")
        self._ensure_state()
        self.manager.save(self._step, self._state, block=True)
        return self._step

    # -------------------------------------------------------------- resume --
    @classmethod
    def resume(cls, ckpt_dir: str, *, device: DeviceLike = None,
               metrics_cb: Optional[Callable[[int, Dict], None]] = None,
               failure_hook: Optional[Callable[[int], None]] = None,
               **overrides) -> "Trainer":
        """A Trainer rebuilt from the RunSpec in the newest checkpoint under
        ``ckpt_dir`` (either package's); ``overrides`` are
        :meth:`RunSpec.replace` arguments (``{"train.steps": 600}``)."""
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        step, spec_dict = CheckpointManager(ckpt_dir).latest_run_spec()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        if spec_dict is None:
            raise ValueError(f"checkpoint step {step} under {ckpt_dir!r} carries no "
                             f"RunSpec; build the spec by hand: Trainer(spec)")
        spec = RunSpec.from_dict(spec_dict)
        merged = {"checkpoint.directory": ckpt_dir}
        merged.update(overrides)
        return cls(spec.replace(**merged), device=device, metrics_cb=metrics_cb,
                   failure_hook=failure_hook)

    # --------------------------------------------------------------- state --
    @property
    def state(self) -> Any:
        self._ensure_state()
        return self._state

    @property
    def params(self) -> Any:
        return self.state["params"]

    @property
    def current_step(self) -> int:
        self._ensure_state()
        return self._step
