"""Server: the serving facade over one :class:`RunSpec` (the reference's
``api/server.py``).

Owns the continuous-batching :class:`ServingEngine` (paged KV cache,
int8 weights, prefix cache, chunked prefill, deadlines, the SLO
scheduler, streaming), built from ``spec.serve`` alone. Three ways in:

  * ``Server(spec)`` — random weights from ``spec.train.seed`` (the
    port's generator: other draws than the reference's);
  * ``Server(spec, params=...)`` — weights already held;
  * ``Server.from_checkpoint(path)`` — zero flags: the RunSpec embedded
    in the newest checkpoint's sidecar (written by either package)
    describes the model, the serving geometry and the quantization;
    ``**overrides`` are :meth:`RunSpec.replace` arguments.

Requests go in through :meth:`submit` (or a ``Request`` list handed to
:meth:`run`); results come back as a dict from :meth:`run` or as they
finish from :meth:`stream`. The server runs on the CUDA device unless
the caller passes ``device="cpu"``. Refused (``NotImplementedError``,
naming the ROADMAP queue 1 item): ``serve.speculative_rank`` and
``draft_tokens`` other than the default (item 6), ``disaggregate`` and
``kv_transfer`` other than ``"raw"`` (item 8), and in
:meth:`Server.from_checkpoint` a ``serve.rank`` other than the
checkpoint's own (item 9; ``Server(spec, ...)`` reads ``serve.rank`` not
at all, as in the reference); ``mode="static"`` is the launcher's oracle
path, not a server (``ValueError``, as in the reference).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.specs import RunSpec, ServeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.scheduler import Request

__all__ = ["Server", "load_run_spec"]


def load_run_spec(ckpt_dir: str) -> Tuple[int, RunSpec]:
    """(step, RunSpec) embedded in the newest checkpoint under
    ``ckpt_dir``. Raises FileNotFoundError for a missing or empty
    directory and ValueError for a checkpoint without an embedded spec."""
    from repro_torch.checkpoint.manager import CheckpointManager

    # a read path must not create the directory (the manager's constructor does)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    step, spec_dict = CheckpointManager(ckpt_dir).latest_run_spec()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    if spec_dict is None:
        raise ValueError(f"checkpoint step {step} under {ckpt_dir!r} embeds no RunSpec: build "
                         "the spec by hand and serve it with Server(spec, params)")
    return step, RunSpec.from_dict(spec_dict)


def _refuse_unported(sv: ServeSpec) -> None:
    default = ServeSpec()
    if sv.speculative_rank is not None or sv.draft_tokens != default.draft_tokens:
        raise NotImplementedError(
            f"serve.speculative_rank={sv.speculative_rank!r}, draft_tokens="
            f"{sv.draft_tokens}: speculative decoding is not ported (ROADMAP queue 1 item 6)")
    if sv.disaggregate or sv.kv_transfer != default.kv_transfer:
        raise NotImplementedError(
            f"serve.disaggregate={sv.disaggregate}, kv_transfer={sv.kv_transfer!r}: "
            "disaggregated serving is not ported (ROADMAP queue 1 item 8)")


class Server:
    """One serving runtime for one model, described by ``spec``. Only
    ``spec.model`` and ``spec.serve`` are read, and ``spec.train.seed``
    when no ``params`` are given. ``spec.serve.mode`` must be
    ``"paged"``."""

    def __init__(self, spec: RunSpec, params: Any = None, *, device: DeviceLike = None):
        if spec.serve.mode != "paged":
            raise ValueError(
                f"Server drives the paged engine; serve.mode is {spec.serve.mode!r} (the "
                "static path lives in launch/serve.py as the verification oracle)")
        sv = spec.serve
        _refuse_unported(sv)
        from repro_torch.models.model import init_model
        from repro_torch.serving.engine import ServingEngine

        self.spec = spec
        self.cfg = spec.model.config()
        self.device = resolve_device(device)
        if params is None:
            params = init_model(self.cfg, seed=spec.train.seed, device=self.device)
        self.engine = ServingEngine(
            self.cfg, params, sv.paged_config(), device=self.device,
            prefill_token_budget=sv.prefill_budget, quantize=sv.quantize,
            prefix_cache=sv.prefix_cache, chunked_prefill=sv.chunked_prefill,
            scheduler=sv.scheduler, shed=sv.shed, streaming=sv.streaming.config(),
            mesh=spec.sharding.serve_mesh())
        self.checkpoint_step: Optional[int] = None
        self._pending: List[Request] = []
        self._next_rid = 0
        # rids owned by this server or its engine (pending, queued, in
        # flight, undelivered); delivery discards, so a finished rid is
        # reusable
        self._live_rids: set = set()

    # -------------------------------------------------------------- load --
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, *, device: DeviceLike = None,
                        **overrides) -> "Server":
        """Serve the newest checkpoint under ``ckpt_dir`` with no flags:
        model and serving geometry from its embedded RunSpec, with
        ``overrides`` (:meth:`RunSpec.replace` arguments) on top. The
        weights are read from the step the spec came from, so a run that
        saves a newer checkpoint between the two reads cannot pair one
        step's spec with another's weights."""
        from repro_torch.serving.engine import params_from_checkpoint

        step, spec = load_run_spec(ckpt_dir)
        spec = spec.replace(**overrides)
        _refuse_unported(spec.serve)
        _, params = params_from_checkpoint(ckpt_dir, rank=spec.serve.rank, step=step,
                                           device=resolve_device(device))
        server = cls(spec, params, device=device)
        server.checkpoint_step = step
        return server

    # ------------------------------------------------------------ submit --
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               arrival: int = 0, eos_id: Optional[int] = None,
               deadline: Optional[int] = None, tenant: Optional[str] = None,
               priority: Optional[int] = None, rid: Optional[int] = None) -> int:
        """Queue one request; returns its rid (the next one free unless
        given; a rid queued or in flight raises). ``max_new_tokens``
        defaults to ``spec.serve.gen``, ``deadline`` to
        ``spec.serve.effective_deadline``, ``tenant``/``priority`` to the
        ``spec.serve`` defaults. The request waits on the host until the
        next :meth:`run`/:meth:`stream`."""
        if rid is None:
            rid = self._next_rid
            while rid in self._live_rids:
                rid += 1
        elif rid in self._live_rids:
            raise ValueError(f"rid {rid} is already queued or in flight: results key on "
                             "rid, so a duplicate would overwrite the other request's output")
        self._live_rids.add(rid)
        self._next_rid = max(self._next_rid, rid + 1)
        sv = self.spec.serve
        self._pending.append(Request(
            rid=rid, prompt=np.asarray(prompt, dtype=np.int32),
            max_new_tokens=max_new_tokens if max_new_tokens is not None else sv.gen,
            arrival=arrival, eos_id=eos_id,
            deadline=deadline if deadline is not None else sv.effective_deadline,
            tenant=tenant if tenant is not None else sv.tenant,
            priority=priority if priority is not None else sv.priority))
        return rid

    def _take(self, requests: Optional[Sequence[Request]]) -> List[Request]:
        if requests is not None:
            return list(requests)
        taken, self._pending = self._pending, []
        # nothing new is fine while the engine holds work an abandoned
        # stream() left behind: a fresh run() or stream() recovers it
        if not taken and not self.engine.has_pending_work:
            raise ValueError("nothing to serve: submit() requests first "
                             "(or pass an explicit Request list)")
        return taken

    # --------------------------------------------------------------- run --
    def run(self, requests: Optional[Sequence[Request]] = None) -> Dict[int, np.ndarray]:
        """Serve everything submitted (or ``requests``) to completion:
        rid -> generated int32 token ids; outcomes in
        :attr:`last_statuses`."""
        return {rid: tokens for rid, tokens, _ in self.stream(requests)}

    def stream(self, requests: Optional[Sequence[Request]] = None
               ) -> Iterator[Tuple[int, np.ndarray, str]]:
        """Yield ``(rid, tokens, status)`` in the engine step each request
        finishes; the engine advances between yields."""
        reqs = self._take(requests)
        self._live_rids.update(r.rid for r in reqs)
        inner = self.engine.serve(reqs)          # hands the requests over now

        def _events():
            for rid, tokens, status in inner:
                self._live_rids.discard(rid)
                yield rid, tokens, status

        return _events()

    def cancel(self, rid: int) -> bool:
        """Cancel a request in flight (between :meth:`stream` iterations)."""
        return self.engine.cancel(rid)

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict[str, float]:
        return self.engine.stats()

    @property
    def last_statuses(self) -> Dict[int, str]:
        return self.engine.last_statuses

    @property
    def params(self) -> Any:
        """The engine's weights as served (int8 codes and scales under
        ``quantize="int8"``: ``serving.quantize.dequantize_tree`` for
        oracles)."""
        return self.engine.params
