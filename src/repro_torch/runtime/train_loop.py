"""The training loop (the reference's ``runtime/train_loop.py``) without
failure injection or a rank controller.

On start the loop resumes from the newest checkpoint under its
directory, or initializes a fresh state, and regenerates the data
stream from the step index, so a resumed run is bit-identical to an
uninterrupted one. Every ``checkpoint_every`` steps, and at the last
step, it checkpoints. The reference's restart-on-failure
(``max_restarts``, ``failure_hook``) comes with fault injection, its
straggler count with a caller that sets a deadline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    log_every: int = 10


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,                                # (state, batch) -> (state, metrics)
        batch_iter_factory: Callable[[int], Iterator],    # start_step -> iterator
        ckpt_dir: str,
        cfg: TrainLoopConfig,
        init_state_fn: Callable[[], Any],
        place_state_fn: Callable[[Any], Any],             # restored numpy tree -> state
        metrics_cb: Optional[Callable[[int, Dict], None]] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
    ):
        self.step_fn = step_fn
        self.batch_iter_factory = batch_iter_factory
        self.cfg = cfg
        self.mgr = checkpoint_manager or CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.init_state_fn = init_state_fn
        self.place_state_fn = place_state_fn
        self.metrics_cb = metrics_cb

    def _start_state(self):
        step, state = self.mgr.restore_latest()
        if state is None:
            return 0, self.init_state_fn()
        return step, self.place_state_fn(state)

    def run(self) -> Any:
        step, state = self._start_state()
        batches = self.batch_iter_factory(step)
        while step < self.cfg.total_steps:
            state, metrics = self.step_fn(state, next(batches))
            step += 1
            if self.metrics_cb and step % self.cfg.log_every == 0:
                self.metrics_cb(step, {k: float(v) for k, v in metrics.items()})
            if step % self.cfg.checkpoint_every == 0 or step == self.cfg.total_steps:
                self.mgr.save(step, state)
        return state
