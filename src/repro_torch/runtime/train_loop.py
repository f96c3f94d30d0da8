"""The fault-tolerant training loop (the reference's
``runtime/train_loop.py``) without a rank controller.

  * checkpoint/restart: on start the loop resumes from the newest
    complete checkpoint under its directory, or initializes a fresh
    state, and regenerates the data stream from the step index, so a
    resumed run is bit-identical to an uninterrupted one. Every
    ``checkpoint_every`` steps, and at the last step, it checkpoints
    (async by default: the host snapshot is taken before the next step).
  * failure injection: ``failure_hook(step)`` runs at the top of every
    step, so tests and chaos drills can raise mid-run; ``run`` turns a
    failed attempt into a checkpoint-backed restart, up to
    ``max_restarts``. The in-memory state of a failed attempt is never
    reused (a step updates it in place, so it may be half updated): the
    restart restores from disk, or initializes from the seed.
  * stragglers: a step whose time (synchronized on its loss) exceeds
    ``step_deadline_s`` is counted in ``straggler_steps``.
  * loss scaling: ``overflow_steps`` is read once, at the end, from the
    state's ``loss_scale["skipped"]``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    step_deadline_s: Optional[float] = None   # straggler threshold
    max_restarts: int = 3
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
        failure_hook: Optional[Callable[[int], None]] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
    ):
        self.step_fn = step_fn
        self.batch_iter_factory = batch_iter_factory
        self.cfg = cfg
        self.mgr = checkpoint_manager or CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.init_state_fn = init_state_fn
        self.place_state_fn = place_state_fn
        self.metrics_cb = metrics_cb
        self.failure_hook = failure_hook
        self.straggler_steps = 0
        self.restarts = 0
        self.overflow_steps = 0

    def _start_state(self):
        step, state = self.mgr.restore_latest()
        if state is None:
            return 0, self.init_state_fn()
        return step, self.place_state_fn(state)

    def run(self) -> Any:
        attempt = 0
        while True:
            try:
                return self._run_once()
            except Exception:  # noqa: BLE001 — any step failure
                attempt += 1
                self.restarts += 1
                if attempt > self.cfg.max_restarts:
                    raise
                # flush the save in flight before the restart touches the
                # directory; its error is swallowed: the restore takes the
                # newest complete checkpoint either way
                try:
                    self.mgr.wait()
                except Exception:  # noqa: BLE001 — writer error
                    pass

    def _run_once(self) -> Any:
        step, state = self._start_state()
        batches = self.batch_iter_factory(step)
        while step < self.cfg.total_steps:
            batch = next(batches)
            t0 = time.perf_counter()
            if self.failure_hook is not None:
                self.failure_hook(step)
            state, metrics = self.step_fn(state, batch)
            float(metrics["loss"])          # the step's time needs its end
            if self.cfg.step_deadline_s and time.perf_counter() - t0 > self.cfg.step_deadline_s:
                self.straggler_steps += 1
            step += 1
            if self.metrics_cb and step % self.cfg.log_every == 0:
                self.metrics_cb(step, {k: float(v) for k, v in metrics.items()})
            if step % self.cfg.checkpoint_every == 0 or step == self.cfg.total_steps:
                self.mgr.save(step, state)
        self.mgr.wait()
        if isinstance(state, dict) and "loss_scale" in state:
            self.overflow_steps = int(state["loss_scale"]["skipped"])
        return state
