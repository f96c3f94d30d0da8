"""Serving engine: continuous batching over paged caches, with
shared-prefix reuse and chunked prefill (the reference's
``serving/engine.py:ServingEngine`` with the FIFO scheduler).

Every prompt prefills through the paged chunk path
(``models/decode.py:prefill_chunk_lm_paged``), which writes KV straight
into the sequence's pages from a logical offset: a prompt whose prefix
is already cached only computes its tail, and with ``chunked_prefill``
the tail is split into budget-sized chunks interleaved with decode
steps. Each engine step then runs one batched decode step for every
decoding slot: ``(max_slots, 1)`` tokens against the shared pools, with
block tables and fill levels as data.

The loop each engine step: expire deadlines -> admit waiting requests
into free slots (FIFO, shared prefixes mapped from the index) -> run
prefill chunks under the step budget -> one batched decode step ->
record tokens, drain finished/cancelled sequences to the caller.

``quantize="int8"`` serves int8 weights (``serving/quantize.py``: the
spectral factors through the int8 kernel, dense projections dequantized
per call). ``streaming=StreamingConfig(...)`` bounds every sequence to
attention sinks plus a sliding window of pages (``serving/streaming.py``;
the scheduler evicts), and with ``cold_kv="int8"`` the engine demotes
the resident pages older than the window into int8 shadow pools that
attention reads through the cold decode kernel. Reference:
``src/repro/serving/engine.py:112-121`` (int8), ``:133-200`` and
``:515-700`` (streaming, the cold tier), ``:750-753`` (the stats).

The recurrent families (``ssm_lm``, xlstm; ``hybrid``, jamba) take the
reference's recurrent prompt path (``src/repro/serving/engine.py:652-669``
``_prefill_full``): the whole prompt prefills from position 0 into a
batch-1 static state, whose attention K/V (hybrid) is written into the
sequence's pages and whose recurrent state is scattered into the
sequence's slot of the engine state; every decode step then advances all
slots at once. Such a family silently opts out of the prefix cache and
chunked prefill, as in the reference; ``streaming=`` raises (its state
cannot drop evicted history), and so does ``quantize="int8"`` until a
test holds it.

The ``moe_lm`` family (deepseek, MLA + MoE) takes the paged chunk path
like ``dense_lm``: its MLA layers write their latent and rope key into
the pages and decode through the absorbed-MLA kernel (the cold one
under ``cold_kv="int8"``). Under ``quantize="int8"`` its dense MLPs run
the int8 kernel and its MLA projections dequantize per call, while the
embedding, the whole ``moe`` subtree (router, expert banks, shared
experts) and ``wukv`` stay raw, as the reference leaves them
(``src/repro/serving/quantize.py:34-40``).

``scheduler="slo"`` admits through :class:`SLOScheduler` (per-tenant fair
share, then priority, then earliest deadline; ``shed=True`` refuses a
request that cannot meet its deadline with status ``"shed"``).
:func:`params_from_checkpoint` loads a training checkpoint's params.

Not ported yet (it raises ``NotImplementedError``): tensor-parallel
serving (``mesh``, ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.model_config import ModelConfig
from repro_torch.checkpoint.manager import CheckpointManager, rank_metadata
from repro_torch.checkpoint.store import to_tensor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.decode import (
    ATTN_STATE_KEYS,
    recurrent_slot_axes,
    supports_prefix_sharing,
)
from repro_torch.models.lm import require_family
from repro_torch.models.model import (
    decode_step_paged,
    init_decode_state,
    init_paged_state,
    prefill,
    prefill_chunk_paged,
    serving_params,
)
from repro_torch.serving.paged_cache import PagedCacheConfig, paged_write_pages, slot_write
from repro_torch.serving.quantize import param_bytes, quantize_kv_pages
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    SeqState,
    SLOScheduler,
)
from repro_torch.serving.streaming import StreamingConfig

# inter-token latency samples kept for percentile stats; bounded so a
# long-lived engine under continuous traffic cannot leak host memory
LATENCY_WINDOW = 4096


def params_from_checkpoint(ckpt_dir: str, *, rank: Optional[int] = None,
                           step: Optional[int] = None, device: DeviceLike = None):
    """(step, params) from a training checkpoint directory (the newest, or
    ``step``), on ``device`` (the card unless the caller passes
    ``device="cpu"``, as everywhere in the port). A full TrainState is stripped to its ``params``; a
    bare params tree passes through. The reference's
    ``src/repro/serving/engine.py:66``; resizing to another ``rank`` at
    load (``rank/resize.py``) is not ported (ROADMAP queue 1 item 9), so
    ``rank`` must be None or the checkpoint's own rank."""
    dev = resolve_device(device)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    mgr = CheckpointManager(ckpt_dir)
    if step is None:
        step, state = mgr.restore_latest()
        if state is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    else:
        state = mgr.restore(step)
    params = state["params"] if isinstance(state, dict) and "params" in state else state
    params = tree_map(lambda a: to_tensor(a, dev), params)
    ranks = set(rank_metadata(params).values())
    if rank is not None and ranks != {int(rank)}:
        raise NotImplementedError(
            f"serving at rank {rank} from a checkpoint of rank(s) {sorted(ranks)} needs "
            "rank/resize.py, which is not ported (ROADMAP queue 1 item 9)")
    return step, params


class ServingEngine:
    """Continuous-batching serving runtime over one model + one paged
    cache pool on one device. Construct with live ``params`` (the fp32
    masters; they are quantized when ``quantize="int8"``, then moved and
    cast to the compute dtype once), optionally ``prefix_cache=True`` /
    ``chunked_prefill=True`` / ``streaming=StreamingConfig(...)``;
    submit ``Request`` traces through :meth:`run`, cancel in-flight
    requests with :meth:`cancel`, read throughput/memory/latency from
    :meth:`stats`."""

    def __init__(self, cfg: ModelConfig, params, pcfg: PagedCacheConfig, *,
                 device: DeviceLike = None,
                 prefill_token_budget: Optional[int] = None,
                 quantize: Optional[str] = None,
                 prefix_cache: bool = False,
                 chunked_prefill: bool = False,
                 scheduler: str = "fifo",
                 shed: bool = True,
                 streaming: Optional[StreamingConfig] = None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError("ServingEngine(mesh=...): tensor-parallel serving is "
                                      "not ported (ROADMAP queue 1 item 8)")
        if scheduler not in ("fifo", "slo"):
            raise ValueError(f"unknown scheduler {scheduler!r}; options: fifo, slo")
        require_family(cfg, "serve")
        self._offset_prefill = supports_prefix_sharing(cfg)
        if streaming is not None and not self._offset_prefill:
            raise NotImplementedError(
                "streaming KV needs the offset-prefill paged path; family "
                f"{cfg.family!r} carries recurrent state that cannot drop evicted history")
        if quantize is not None and not self._offset_prefill:
            raise NotImplementedError(
                f"quantize={quantize!r} on the recurrent family {cfg.family!r} is not "
                "ported (no test of the reference serves it)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.weight_bytes_fp = param_bytes(params)
        self.quantize = quantize
        self.params = serving_params(params, cfg, self.device, quantize=quantize)
        self.weight_bytes = param_bytes(self.params)
        self.pcfg = pcfg
        self.prefill_token_budget = prefill_token_budget
        # chunk size for chunked prefill: the step budget when set, else
        # a few pages' worth
        self.prefill_chunk = prefill_token_budget or 4 * pcfg.page_size
        # recurrent families silently opt out (models/decode.py)
        self.prefix_cache = bool(prefix_cache) and self._offset_prefill
        self.chunked_prefill = bool(chunked_prefill) and self._offset_prefill
        # streaming KV policy: attention sinks + sliding-window eviction
        # + an optional int8 cold tier (serving/streaming.py)
        self.streaming = streaming
        self._cold = streaming is not None and streaming.cold_kv == "int8"
        self.state = init_paged_state(cfg, pcfg, device=self.device,
                                      cold_kv="int8" if self._cold else "none")
        if scheduler == "slo":
            self.sched: ContinuousBatchingScheduler = SLOScheduler(
                pcfg, prefill_token_budget, prefix_sharing=self.prefix_cache,
                streaming=streaming, shed=shed)
        else:
            self.sched = ContinuousBatchingScheduler(
                pcfg, prefill_token_budget, prefix_sharing=self.prefix_cache,
                streaming=streaming)
        self.scheduler = scheduler
        self._next_input = np.zeros((pcfg.max_slots,), dtype=np.int64)

        # cold-tier bookkeeping: a host flag per physical page (1 = the
        # int8 shadow copy is what attention reads), mirrored to the
        # device when it changed, cleared whenever the pool frees a page
        # (evict, finish, cancel, prefix-cache eviction: one hook)
        self.stream_demotions = 0
        self.cold_page_bytes = 0
        self._cold_np = np.zeros((pcfg.num_pages + 1,), dtype=np.int32)
        self._cold_dev: Optional[torch.Tensor] = None
        self._cold_bytes_per_page = 0
        if self._cold:
            self.sched.pool.on_free = self._on_pages_freed
            # int8 shadow bytes one demoted page occupies across every
            # layer of every q8 leaf (the reference's cost metric)
            self._cold_bytes_per_page = sum(
                leaf.shape[0] * int(np.prod(leaf.shape[2:]))
                for key in ATTN_STATE_KEYS
                for name, leaf in self.state.get(key, {}).items() if name.endswith("_q8"))

        # stats (bounded: counters + a fixed-width latency window)
        self.prefill_tokens = 0          # prompt tokens actually computed
        self.prefill_chunks = 0          # chunk-prefill steps run
        self.prompt_tokens = 0           # prompt tokens admitted
        self.prefix_shared_tokens = 0    # prompt tokens served from the index
        self.decoded_tokens = 0
        self.decode_steps = 0
        self.requests_done = 0
        self.generated_total = 0
        self.cancelled = 0
        self.timed_out = 0
        self.shed = 0
        self.wall_s = 0.0
        self.step_times: Deque[float] = deque(maxlen=LATENCY_WINDOW)
        self.last_statuses: Dict[int, str] = {}
        # completions drained but not yet handed to a consumer, and
        # requests not yet submitted (future arrivals): engine state, so
        # an abandoned serve() generator loses neither
        self._undelivered: List[tuple] = []
        self._backlog: List[Request] = []
        self._clock = 0

    # --------------------------------------------------------------- run --
    def serve(self, requests: Sequence[Request]):
        """Generator form of the serving loop: one engine step per
        iteration, yielding ``(rid, tokens, status)`` as each request
        finishes. ``Request.arrival`` staggers enqueueing in engine-step
        time. :meth:`run` is the collect-everything wrapper."""
        if not self.has_pending_work:
            self._clock = 0
        self._backlog = sorted(self._backlog + list(requests), key=lambda r: r.arrival)
        return self._serve_loop()

    def _deliver(self):
        while self._undelivered:
            rid, tokens, status = self._undelivered.pop(0)
            self.last_statuses[rid] = status
            yield (rid, tokens, status)

    def _serve_loop(self):
        self.last_statuses = {}
        t0 = time.time()
        last_decode_t = None
        try:
            yield from self._deliver()
            while self._backlog or self.sched.has_work:
                while self._backlog and self._backlog[0].arrival <= self._clock:
                    self.sched.submit(self._backlog.pop(0), now=self._clock)
                self.sched.expire_deadlines(self._clock)
                for seq in self.sched.admit():
                    self.prompt_tokens += seq.request.prompt_len
                    self.prefix_shared_tokens += seq.shared_len
                self._prefill_step()
                if any(s.status == "decoding" for s in self.sched.active.values()):
                    self._decode_once()
                    # inter-token latency = gap between consecutive decode
                    # completions (the host reads each step's tokens, so
                    # the step has finished on the device); prefill work
                    # scheduled between decode steps lands in the tail
                    now = time.time()
                    if last_decode_t is not None:
                        self.step_times.append(now - last_decode_t)
                    last_decode_t = now
                self._undelivered.extend(
                    (seq.request.rid, np.asarray(seq.generated, dtype=np.int32), seq.status)
                    for seq in self._drain())
                yield from self._deliver()
                self._clock += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.wall_s += time.time() - t0

    def run(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        """Serve a trace to completion: rid -> generated token ids."""
        return {rid: tokens for rid, tokens, _ in self.serve(requests)}

    @property
    def peak_pages(self) -> int:
        return self.sched.pool.peak_allocated

    @property
    def has_pending_work(self) -> bool:
        return bool(self._undelivered) or bool(self._backlog) or self.sched.has_work

    def cancel(self, rid: int) -> bool:
        """Cancel a request mid-flight (queue or active)."""
        return self.sched.cancel(rid)

    def _drain(self) -> List[SeqState]:
        drained = self.sched.drain_finished()
        for seq in drained:
            self.last_statuses[seq.request.rid] = seq.status
            self.requests_done += 1
            self.generated_total += len(seq.generated)
            if seq.status == "cancelled":
                self.cancelled += 1
            elif seq.status == "timeout":
                self.timed_out += 1
            elif seq.status == "shed":
                self.shed += 1
        return drained

    # ------------------------------------------------------------- steps --
    @torch.no_grad()
    def _prefill_step(self) -> None:
        """Advance every prefilling sequence, FIFO, under the per-step
        chunk budget (when chunking; otherwise each tail runs whole).
        The first chunk of a step always runs — progress guarantee."""
        budget = self.prefill_chunk if self.chunked_prefill else None
        # streaming caps every chunk at a window of tokens: eviction can
        # then always make room, and each chunk advances by at least a page
        cap = (self.streaming.window_pages * self.pcfg.page_size
               if self.streaming is not None else None)
        spent = 0
        for seq in self.sched.prefilling():
            if not self._offset_prefill:
                self._prefill_full(seq)
                continue
            plen = seq.request.prompt_len
            logits = None
            while seq.prefill_pos < plen:
                remaining = plen - seq.prefill_pos
                c = remaining if budget is None else min(remaining, max(1, budget - spent))
                if cap is not None:
                    c = min(c, cap)
                if budget is not None and spent > 0 and spent + c > budget:
                    return                       # budget exhausted; resume next step
                if self.streaming is not None:
                    self.sched.stream_prepare_chunk(seq.slot, c)
                    self._stream_demote(seq.slot)
                logits = self._run_chunk(seq, c)
                spent += c
            self._complete_prefill(seq, logits)
            if budget is not None and spent >= budget:
                return

    def _run_chunk(self, seq: SeqState, c: int):
        req = seq.request
        toks = torch.as_tensor(req.prompt[seq.prefill_pos:seq.prefill_pos + c],
                               dtype=torch.int64).to(self.device)[None]
        bt = torch.as_tensor(self.sched.block_table[seq.slot:seq.slot + 1]).to(self.device)
        # cache-slot-relative start: evicted history no longer occupies
        # cache positions (the StreamingLLM position contract)
        start = seq.prefill_pos - seq.evicted_tokens
        logits, self.state = prefill_chunk_paged(self.params, toks, self.state, bt,
                                                 start, self.cfg,
                                                 cold_flags=self._cold_flags())
        seq.prefill_pos += c
        self.prefill_tokens += c
        self.prefill_chunks += 1
        return logits

    def _prefill_full(self, seq: SeqState) -> None:
        """The recurrent prompt path: the whole prompt from position 0
        into a batch-1 static state; its attention K/V is written into the
        sequence's pages (every stacked layer at once) and its recurrent
        state scattered into the sequence's slot. Every leaf of the slot
        is overwritten, so whatever the slot's state became while it idled
        (decode steps every slot) is gone."""
        req = seq.request
        toks = torch.as_tensor(req.prompt, dtype=torch.int64).to(self.device)[None]
        tmp = init_decode_state(self.cfg, 1, req.prompt_len, device=self.device)
        logits, filled = prefill(self.params, toks, self.cfg, tmp)
        page_ids = torch.as_tensor(seq.pages, dtype=torch.int64).to(self.device)
        for key in ATTN_STATE_KEYS:
            for name, vals in filled.get(key, {}).items():
                paged_write_pages(self.state[key][name], page_ids, vals[:, 0], n_stack=1)
        for key, axis in recurrent_slot_axes(self.cfg).items():
            slot_write(self.state[key], axis, seq.slot, filled[key])
        seq.prefill_pos = req.prompt_len
        self.prefill_tokens += req.prompt_len
        self._complete_prefill(seq, logits)

    # --------------------------------------------------------- streaming --
    def _cold_flags(self) -> Optional[torch.Tensor]:
        """Device copy of the per-page cold flags (None without the cold
        tier), rebuilt only when the host mirror changed."""
        if not self._cold:
            return None
        if self._cold_dev is None:
            self._cold_dev = torch.tensor(self._cold_np, device=self.device)
        return self._cold_dev

    def _on_pages_freed(self, pages) -> None:
        """PagePool.on_free hook: a freed page's shadow copy is stale;
        whatever sequence reuses the page starts hot."""
        idx = np.asarray(pages)
        if len(idx) and self._cold_np[idx].any():
            self._cold_np[idx] = 0
            self._cold_dev = None

    def _demote(self, page: int) -> None:
        """Quantize physical page ``page`` of every layer's K and V pools
        (``quantize_kv_pages``: one fp32 scale per layer, head and
        feature) into the shadow leaves. Unlike the reference's
        functional update, it writes the shadow pools in place."""
        for key in ATTN_STATE_KEYS:
            cache = self.state.get(key, {})
            for name in [n for n in cache if n + "_q8" in cache]:
                qt = quantize_kv_pages(cache[name][:, page], token_axis=1)
                cache[name + "_q8"][:, page] = qt["q8"]
                cache[name + "_scale"][:, page] = qt["scale"]

    def _stream_demote(self, slot: int) -> None:
        """Demote this slot's newly cold pages (resident, outside the
        window, unshared) into the int8 shadow pools."""
        if not self._cold:
            return
        for p in self.sched.stream_cold_pages(slot):
            if self._cold_np[p]:
                continue
            self._demote(p)
            self._cold_np[p] = 1
            self._cold_dev = None
            self.stream_demotions += 1
            self.cold_page_bytes += self._cold_bytes_per_page

    def _complete_prefill(self, seq: SeqState, logits) -> None:
        tok = int(torch.argmax(logits[0, -1]))
        self._next_input[seq.slot] = tok
        self.sched.finish_prefill(seq.slot)
        self.sched.on_prefill_token(seq.slot, tok)

    @torch.no_grad()
    def _decode_once(self) -> None:
        if self.streaming is not None:
            # window maintenance first: eviction may shrink seq_len, so
            # it precedes the append-capacity check for the next token
            for slot, seq in list(self.sched.active.items()):
                if seq.status == "decoding":
                    self.sched.stream_maintain(slot, 1)
                    self._stream_demote(slot)
        for _, src, dst in self.sched.ensure_append_capacity():
            # copy-on-write fork: duplicate the shared page in every
            # layer's pools before the batched append may write it
            for key in ATTN_STATE_KEYS:
                for pool in self.state.get(key, {}).values():
                    pool[:, dst] = pool[:, src]
        bt_np, sl_np = self.sched.decode_view()
        bt = torch.as_tensor(bt_np).to(self.device)
        sl = torch.as_tensor(sl_np).to(self.device)
        toks = torch.as_tensor(self._next_input).to(self.device)[:, None]
        logits, self.state = decode_step_paged(self.params, toks, self.state, bt, sl,
                                               self.cfg, cold_flags=self._cold_flags())
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        decoding = [s for s, seq in self.sched.active.items() if seq.status == "decoding"]
        for slot in decoding:
            tok = int(nxt[slot])
            self._next_input[slot] = tok
            self.sched.on_token(slot, tok)
        self.decode_steps += 1
        self.decoded_tokens += len(decoding)

    # ------------------------------------------------------------- stats --
    def attn_cache_bytes(self) -> int:
        """Bytes held by the paged attention pools."""
        return sum(t.numel() * t.element_size()
                   for key in ATTN_STATE_KEYS for t in self.state.get(key, {}).values())

    def recurrent_state_bytes(self) -> int:
        """Bytes held by the slots' recurrent state (ssm_lm, hybrid)."""
        return sum(t.numel() * t.element_size()
                   for key in recurrent_slot_axes(self.cfg)
                   for t in tree_leaves(self.state[key]))

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 inter-token latency (seconds) over the sliding window
        of gaps between consecutive decode-step completions."""
        if not self.step_times:
            return {"itl_p50_s": 0.0, "itl_p99_s": 0.0}
        arr = np.asarray(self.step_times)
        return {"itl_p50_s": float(np.percentile(arr, 50)),
                "itl_p99_s": float(np.percentile(arr, 99))}

    def stats(self) -> Dict[str, float]:
        gen = self.generated_total
        out = {
            "requests": float(self.requests_done),
            "cancelled": float(self.cancelled),
            "timed_out": float(self.timed_out),
            "shed": float(self.shed),
            "peak_pages": float(self.peak_pages),
            "prefill_tokens": float(self.prefill_tokens),
            "prefill_chunks": float(self.prefill_chunks),
            "prompt_tokens": float(self.prompt_tokens),
            "prefix_shared_tokens": float(self.prefix_shared_tokens),
            "generated_tokens": float(gen),
            "decode_steps": float(self.decode_steps),
            "cow_forks": float(self.sched.cow_forks),
            "wall_s": self.wall_s,
            "tokens_per_s": (self.prefill_tokens + gen) / self.wall_s if self.wall_s else 0.0,
            "attn_cache_bytes": float(self.attn_cache_bytes()),
            "recurrent_state_bytes": float(self.recurrent_state_bytes()),
            "weight_bytes": float(self.weight_bytes),
            "weight_bytes_fp": float(self.weight_bytes_fp),
        }
        out.update(self.latency_percentiles())
        if self.streaming is not None:
            out["stream_evictions"] = float(self.sched.stream_evictions)
            out["stream_demotions"] = float(self.stream_demotions)
            out["cold_page_bytes"] = float(self.cold_page_bytes)
        if self.sched.prefix_cache is not None:
            out.update({k: float(v) for k, v in self.sched.prefix_cache.stats().items()})
        if isinstance(self.sched, SLOScheduler):
            out.update({k: float(v) for k, v in self.sched.stats().items()})
        return out
