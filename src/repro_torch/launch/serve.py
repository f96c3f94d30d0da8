"""Serving launcher of the port: a thin argparse adapter over the
experiment API. Flags map onto a RunSpec (``api/specs.py``;
``--dump-spec`` prints it, the reference's JSON for the same flags), and
the paged mode replays a staggered trace of variable-length requests
through :class:`repro_torch.api.Server`.

  python -m repro_torch.launch.serve --arch llama3.2-1b --paged --stream --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --paged --stream --verify --device cpu

  python -m repro_torch.launch.serve --arch llama3.2-1b --paged --stream \\
      --quantize int8 --streaming-window 4 --cold-kv int8 --verify

  python -m repro_torch.launch.serve --arch xlstm-1.3b --paged --stream --verify

  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --paged --stream

Runs on the CUDA device unless ``--device`` names another. The weights
are random, from ``--seed``. ``--verify`` checks every request against
the batch-1 static-cache greedy path (:func:`static_greedy_reference`):
in fp32 compute it requires identical tokens; in bf16 it requires every
request to equal the same request served alone by a fresh engine
(:func:`replay_alone`, bit for bit) and every token to lie within the
tolerance ladder of the static path, teacher-forced
(:func:`static_logit_gaps`) — :func:`check_oracles`, the check
``chip_smoke.py`` runs too. Under ``--streaming-window`` only the
requests within the identity horizon (sink + window pages of tokens)
are checked, since eviction changes what a longer one attends to (the
reference CLI's ``src/repro/launch/serve.py:216-232``).

``--arch xlstm-1.3b`` (the ``ssm_lm`` family) serves through the
recurrent prompt path: each prompt prefills whole from position 0
through the chunkwise mLSTM kernel and its state is scattered into the
request's slot; decode steps every slot's recurrent state.

``--arch jamba-v0.1-52b`` (the ``hybrid`` family) takes the same path:
the prompt's mamba layers run the selective-scan kernel, its attention
K/V is written into the request's pages and its mamba state into its
slot; decode steps every slot through the paged decode kernel and the
mamba recurrence. Its MoE layers size expert capacity per forward, so a
decode step's capacity depends on the slot count: where it binds
(:func:`decode_capacity_binds`) the engine's batched decode drops other
tokens than the static path, and ``--verify`` refuses to run (the
reference's tests pin ``capacity_factor=8.0`` for the same reason).

``--arch deepseek-v3-671b`` (the ``moe_lm`` family) serves through the
paged chunk path like the dense family: MLA writes each layer's latent
and rope key into the pages, and decode runs the absorbed-MLA kernel
(its cold variant under ``--cold-kv int8``). Its MoE sizes capacity per
forward as jamba's does, and ``--verify`` refuses where it binds (the
config's 1.25, and 8.0 too, at 4 slots of 256 experts top-8). At full
width its 61 layers (65 G parameters) do not fit one card; ``--reduced``
runs anywhere, and ``chip_smoke.py`` serves it cut to 8 layers.

``--quantize int8`` serves int8 weights (spectral factors and dense
projections; for ``moe_lm`` the embedding, the MoE subtree and ``wukv``
stay raw, as in the reference). Its ``--verify`` oracle is the static
path over the engine's own int8 tree. The reference CLI's oracle is the fp32 static
path over ``dequantize_tree(engine.params)``; here that agreement, and
the agreement with the unquantized weights, are printed as diagnostics
only: on the card the dequantized oracle runs the bf16 kernel, whose
``x @ (q8 * scale)`` rounds the dequantized factor to bf16 where the
int8 kernel multiplies exact codes and applies the fused gain
``u_scale * s * v_scale`` to h in fp32, and that reassociation can flip
a greedy token where fp32 on the CPU does not.

The static path is exact on the CPU in fp32. In bf16 on the card it is
not bit for bit the engine: its decode attention sums in another order
than the paged kernel (and its batch-1 steps may take other GEMM
kernels than the engine's batched ones), so a bf16 logit can land one
rounding step away and a near-tie between two tokens can go the other
way. :func:`replay_alone` is the exact oracle there, and
:func:`static_logit_gaps` holds the tokens to the static path within
the tolerance ladder.

``--streaming-window W`` keeps the ``--sink-pages`` pinned pages plus a
window of W pages resident per sequence; ``--cold-kv int8`` demotes the
resident pages older than the window to int8 shadow pools.

``--arch qwen2-vl-72b`` serves the dense family with QKV bias and M-RoPE
(text-only positions: three equal streams); its LM head is the
embedding's transpose, as the reference builds every family.

``--scheduler slo`` admits through the SLO scheduler (per-tenant fair
share, priority, earliest deadline; doomed requests shed).
``--ckpt-dir DIR`` serves the newest training checkpoint under DIR (the
flags still give the geometry; ``Server.from_checkpoint`` is the
zero-flag form).

Static mode (neither ``--paged`` nor ``--stream``): one batch of
``--batch`` prompts of ``--prompt-len`` tokens from a seeded torch
generator (the reference draws them with ``jax.random``), one prefill
and ``--gen - 1`` batched decode steps over the dense static cache
(:func:`run_static`). ``--quantize int8`` serves the int8 tree there;
its ``--verify`` holds the int8 tokens to the static path over the
dequantized weights: token for token in fp32 compute, within the ladder
teacher-forced in bf16 (:func:`static_logit_gaps`, as the paged
``--verify`` does).

Refused, with the ROADMAP queue 1 item that ports them: ``--serve-rank``
(item 9), ``--speculative-rank`` (item 6), ``--disaggregate`` and
``--tp`` above 1 (item 8).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api import ModelSpec, RunSpec, Server, ServeSpec, ShardingSpec, StreamingSpec
from repro_torch.device import compute_dtype, resolve_device
from repro_torch.kernels.testing import tolerance_for
from repro_torch.models.decode import ATTN_STATE_KEYS, recurrent_slot_axes
from repro_torch.models.model import (
    decode_step,
    decode_step_paged,
    init_decode_state,
    init_model,
    prefill,
    serving_params,
)
from repro_torch.nn.moe import capacity
from repro_torch.serving.engine import ServingEngine, params_from_checkpoint
from repro_torch.serving.paged_cache import slot_write
from repro_torch.serving.quantize import dequantize_tree, param_bytes
from repro_torch.serving.scheduler import Request
from repro_torch.serving.streaming import identity_horizon


def build_trace(args, vocab, pcfg):
    """Staggered mixed-length request trace: lengths cycle through a
    spread around --prompt-len, arrivals step every --arrive-every
    engine steps. With --shared-prefix, every prompt starts with the
    same system-prompt prefix; with --request-timeout, each request
    carries that deadline. Same trace as the reference for the same
    flags."""
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, vocab, size=(args.shared_prefix,)).astype(np.int32) \
        if args.shared_prefix else np.zeros((0,), np.int32)
    lens = [max(2, args.prompt_len + d) for d in (-7, 0, 5, -3, 9, 2, -5, 12)]
    reqs = []
    for i in range(args.requests):
        plen = lens[i % len(lens)]
        gen = max(1, args.gen + (i % 3) * 4 - 4)
        if gen + 2 + args.shared_prefix > pcfg.max_seq:
            raise SystemExit(
                f"request {i}: gen={gen} (spread from --gen {args.gen}) plus a "
                f">=2-token prompt (+{args.shared_prefix} shared prefix) exceeds "
                f"page-size x pages-per-seq = {pcfg.max_seq} tokens")
        plen = min(plen, pcfg.max_seq - gen - args.shared_prefix)
        tail = rng.integers(0, vocab, size=(plen,)).astype(np.int32)
        reqs.append(Request(
            rid=i,
            prompt=np.concatenate([shared, tail]),
            max_new_tokens=gen,
            arrival=i // max(1, args.slots) * args.arrive_every,
            deadline=args.request_timeout,
        ))
    return reqs


def _static_start(cfg, params, prompt, max_seq, rows, dev, page_size=None):
    """The static path's prefill of ``prompt``; with ``rows`` > 1 the
    state then carries ``rows`` rows, the prompt's state (its recurrent
    state and any attention cache) in row 0 and empty state elsewhere, so
    that the decode steps run at that batch. With ``page_size`` the
    attention caches then become paged pools in logical order (row i's
    positions on pages i n .. i n + n - 1, n = max_seq / page_size, and a
    null page) that the decode steps read through the engine's paged
    decode. A 2-D ``prompt`` (batch, prompt_len) prefills the batch at
    once, one row a prompt (``rows`` is then its batch). Returns (logits,
    state, the block table or None)."""
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64).to(dev)
    if toks.ndim == 1:
        toks = toks[None]
    state = init_decode_state(cfg, toks.shape[0], max_seq, device=dev)
    logits, state = prefill(params, toks, cfg, state)
    if rows > toks.shape[0]:
        full = init_decode_state(cfg, rows, max_seq, device=dev)
        for key, axis in recurrent_slot_axes(cfg).items():
            slot_write(full[key], axis, 0, state[key])
        for key in ATTN_STATE_KEYS:
            for name, leaf in state.get(key, {}).items():
                full[key][name][:, :1] = leaf       # (layers, batch, max_seq, ...)
        state = full
    if page_size is None:
        return logits, state, None
    n = max_seq // page_size
    if n * page_size != max_seq:
        raise ValueError(f"max_seq {max_seq} is not a whole number of {page_size}-token pages")
    for key in ATTN_STATE_KEYS:
        for name, leaf in state.get(key, {}).items():
            pool = leaf.reshape(leaf.shape[0], rows * n, page_size, *leaf.shape[3:])
            state[key][name] = torch.cat([pool, torch.zeros_like(pool[:, :1])], dim=1)
    return logits, state, torch.arange(rows * n, dtype=torch.int32, device=dev).view(rows, n)


def _static_step(cfg, params, tok, state, pos, rows, dev, block_table=None):
    """One decode step at position ``pos`` over ``rows`` rows: ``tok`` (an
    int, or one token a row of a batch) in the leading rows, the logits of
    those rows returned."""
    tok = torch.as_tensor(np.atleast_1d(np.asarray(tok)), dtype=torch.int64).to(dev)
    toks = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
    toks[:tok.shape[0], 0] = tok
    if block_table is None:
        logits, state = decode_step(params, toks, state, pos, cfg)
    else:
        lens = torch.full((rows,), pos, dtype=torch.int32, device=dev)
        logits, state = decode_step_paged(params, toks, state, block_table, lens, cfg)
    return logits[:tok.shape[0]], state


def static_rows(engine: ServingEngine) -> int:
    """The batch of the static path's decode steps when it checks
    ``engine``: 1, or the engine's slot count for a recurrent family.
    Such an engine steps every slot at once, so its step's shape is
    (slots, 1) whatever is active; torch's batched products (``bmm``)
    round differently at another batch, the recurrent state carries the
    difference from step to step, and a model this sensitive to rounding
    (xlstm-1.3b with random weights in bf16 on the card) lands the
    batch-1 path many times the ladder's allowance away within a few
    tokens. At the engine's batch the static path tests the engine's own
    machinery (prompt path, slot scatter, scheduling) bit for bit."""
    return engine.pcfg.max_slots if recurrent_slot_axes(engine.cfg) else 1


def static_page_size(engine: ServingEngine) -> Optional[int]:
    """The page size through which the static path's decode steps read
    their K/V when it checks ``engine``: the engine's, for a recurrent
    family with attention layers (hybrid), else None (fp32 attention over
    the static cache). Such a model routes its MoE on bf16 router logits:
    an attention output one bf16 step away flips a top-2 choice, the
    recurrent state keeps the difference, and the static path departs by
    whole tokens (jamba-v0.1-52b in bf16 on an H100: row 0's routing
    differed at 45-67 (step, layer) pairs of a request, teacher-forced;
    ``tools/jamba_probe.py``).
    Read through the paged decode in the engine's page geometry, the
    static path rounds as the engine does and checks its prompt path,
    page writes, slot scatter and scheduling bit for bit; the decode
    kernel is held to its plain version on its own."""
    if recurrent_slot_axes(engine.cfg) and any(k in engine.state for k in ATTN_STATE_KEYS):
        return engine.pcfg.page_size
    return None


@torch.no_grad()
def static_greedy_reference(cfg, params, prompt, gen, max_seq, *, device=None, rows=1,
                            page_size=None):
    """Static-cache greedy decode — the token-for-token oracle for
    --verify: the same spectral kernel as the engine, fp32 decode
    attention over the gathered static cache instead of the paged
    kernel. ``params`` are cast as the engine casts them (a no-op on
    an engine's own params). ``rows``: the decode steps' batch
    (:func:`static_rows`); ``page_size``: read the K/V through the paged
    decode instead (:func:`static_page_size`)."""
    dev = resolve_device(device)
    params = serving_params(params, cfg, dev)
    logits, state, bt = _static_start(cfg, params, prompt, max_seq, rows, dev, page_size)
    toks = [int(torch.argmax(logits[0, -1]))]
    for i in range(gen - 1):
        logits, state = _static_step(cfg, params, toks[-1], state, len(prompt) + i, rows, dev,
                                     bt)
        toks.append(int(torch.argmax(logits[0, -1])))
    return np.asarray(toks, dtype=np.int32)


def replay_alone(engine: ServingEngine, request: Request) -> np.ndarray:
    """``request`` served alone by a fresh engine with ``engine``'s
    configuration and weights: the exact oracle for what batching,
    paging, eviction and demotion may not change. The step shapes are
    the engine's (its slot count, page geometry and chunking), and every
    kernel on the path computes a row, a slot, the same way whatever
    shares the step with it, so the tokens are identical bit for bit —
    where the static path, whose attention sums in another order, can
    land a bf16 logit one rounding step away and flip a near-tie."""
    solo = ServingEngine(engine.cfg, engine.params, engine.pcfg, device=engine.device,
                         prefill_token_budget=engine.prefill_token_budget,
                         prefix_cache=engine.prefix_cache,
                         chunked_prefill=engine.chunked_prefill, streaming=engine.streaming)
    alone = Request(rid=request.rid, prompt=request.prompt,
                    max_new_tokens=request.max_new_tokens, eos_id=request.eos_id)
    return solo.run([alone])[request.rid]


@torch.no_grad()
def static_logit_gaps(cfg, params, prompt, tokens, max_seq, *, device=None,
                      rows=1, page_size=None) -> np.ndarray:
    """Teacher-forced static path over ``tokens``: at every generated
    position, the static path's best logit less its logit for the token
    given, over the ladder's allowance for that step (``atol * rms +
    rtol * |best|`` of the compute dtype's rung, logits in fp32). A
    value <= 1 means the token given is the static path's choice within
    the kernels' tolerance; greedy tokens of a correct engine stay there
    even where a near-tie flips them. ``rows``, ``page_size``: as in
    :func:`static_greedy_reference`."""
    dev = resolve_device(device)
    params = serving_params(params, cfg, dev)
    tol = tolerance_for(compute_dtype(cfg))
    logits, state, bt = _static_start(cfg, params, prompt, max_seq, rows, dev, page_size)
    gaps = []
    for i, tok in enumerate(np.asarray(tokens)):
        lg = logits[0, -1].float()
        best = lg.max()
        rms = torch.sqrt(torch.mean(lg * lg))
        gaps.append(float((best - lg[int(tok)]) / (tol.atol * rms + tol.rtol * best.abs())))
        if i + 1 < len(tokens):
            logits, state = _static_step(cfg, params, tok, state, len(prompt) + i, rows, dev,
                                         bt)
    return np.asarray(gaps)


def check_oracles(engine: ServingEngine, alone, out, to_static) -> dict:
    """The bf16 gate: every request of ``alone`` equals its replay alone
    through a fresh engine of the same configuration (exact), and the
    requests of ``to_static`` stay within the tolerance ladder of the
    static path, teacher-forced over the engine's tokens (gap <= 1), its
    steps at :func:`static_rows` and :func:`static_page_size`. Raises
    ``AssertionError`` at the first departure; returns the counts and the
    largest gap."""
    def done(r):
        return engine.last_statuses.get(r.rid) == "finished"

    for r in alone:
        got = out[r.rid]
        solo = replay_alone(engine, r)
        if not np.array_equal(solo if done(r) else solo[:len(got)], got):
            first = int(np.argmax(solo[:len(got)] != got)) if len(solo) >= len(got) else 0
            raise AssertionError(f"request {r.rid}: engine tokens differ from the request "
                                 f"served alone at position {first}:\n  alone  {solo}\n"
                                 f"  engine {got}")
    worst, exact, total = 0.0, 0, 0
    for r in to_static:
        gaps = static_logit_gaps(engine.cfg, engine.params, r.prompt, out[r.rid],
                                 engine.pcfg.max_seq, device=engine.device,
                                 rows=static_rows(engine),
                                 page_size=static_page_size(engine))
        if len(gaps) == 0:
            continue
        worst = max(worst, float(gaps.max()))
        exact += int(np.sum(gaps == 0.0))
        total += len(gaps)
        if gaps.max() > 1.0:
            first = int(np.argmax(gaps > 1.0))
            raise AssertionError(f"request {r.rid}: token {first} is {gaps[first]:.3f}x the "
                                 f"ladder's allowance below the static path's best logit")
    return {"alone": len(alone), "static": len(to_static), "max_gap": worst,
            "exact": exact, "tokens": total}


def decode_capacity_binds(cfg, slots: int) -> Optional[int]:
    """The expert capacity of a decode step over ``slots`` rows when it is
    below ``slots`` (a step can then drop a token its rows route to an
    expert), else None (no experts, or capacity never binds)."""
    if not cfg.n_experts:
        return None
    cap = capacity(cfg, slots, cfg.capacity_factor)
    return cap if cap < slots else None


def run_stream(args, spec: RunSpec, params) -> ServingEngine:
    """Replay the trace of ``args`` through a :class:`Server` built from
    ``spec`` over ``params``; print the run's numbers and, with
    ``--verify``, check it (:func:`verify`). Returns the engine."""
    server = Server(spec, params, device=args.device)
    engine = server.engine
    pcfg, scfg = engine.pcfg, engine.streaming
    cfg = server.cfg
    trace = build_trace(args, cfg.vocab, pcfg)
    print(f"streaming {len(trace)} requests, prompt lens "
          f"{sorted({r.prompt_len for r in trace})}, slots={pcfg.max_slots}, "
          f"pool={pcfg.num_pages}x{pcfg.page_size} tokens, device={engine.device}")
    out = server.run(trace)
    engine.sched.check_invariants()
    st = server.stats()
    print(f"served {int(st['requests'])} requests: "
          f"{int(st['prefill_tokens'])} prefill + {int(st['generated_tokens'])} generated "
          f"tokens in {st['wall_s']:.2f}s ({st['tokens_per_s']:.1f} tok/s)")
    if st["recurrent_state_bytes"]:
        print(f"recurrent state: {int(st['recurrent_state_bytes'])} bytes "
              f"({pcfg.max_slots} slots)")
    else:
        print(f"paged attention cache: {int(st['attn_cache_bytes'])} bytes "
              f"({pcfg.num_pages}+1 pages x {pcfg.page_size} tokens)")
    if args.prefix_cache:
        saved, total = int(st["prefix_shared_tokens"]), int(st["prompt_tokens"])
        print(f"prefix cache: {saved}/{total} prompt tokens served from cache")
    print(f"inter-token latency: p50 {st['itl_p50_s'] * 1e3:.1f} ms, "
          f"p99 {st['itl_p99_s'] * 1e3:.1f} ms")
    if scfg is not None:
        line = (f"streaming: sink={scfg.sink_pages}p + window={scfg.window_pages}p "
                f"resident cap, {int(st['stream_evictions'])} pages evicted")
        if scfg.cold_kv == "int8":
            line += (f", {int(st['stream_demotions'])} demoted to int8 "
                     f"({int(st['cold_page_bytes'])} shadow bytes)")
        print(line)
    if args.request_timeout is not None or args.scheduler == "slo":
        print(f"deadlines: {int(st['timed_out'])} timed out, {int(st['cancelled'])} cancelled"
              + (f", {int(st['shed'])} shed" if args.scheduler == "slo" else ""))
    if args.quantize:
        print(f"weights: {int(st['weight_bytes'])} bytes {args.quantize} "
              f"(fp32 {int(st['weight_bytes_fp'])} bytes, "
              f"{st['weight_bytes_fp'] / st['weight_bytes']:.2f}x smaller)")
    print("generated token ids (request 0):", out[trace[0].rid][:16], "...")
    if args.verify:
        verify(engine, trace, out, params)
    return engine


def static_prompts(args, vocab: int) -> np.ndarray:
    """The static mode's (batch, prompt_len) prompts from a seeded torch
    generator on the host."""
    gen = torch.Generator().manual_seed(args.seed)
    return torch.randint(0, vocab, (args.batch, args.prompt_len), generator=gen,
                         dtype=torch.int64).numpy().astype(np.int32)


@torch.no_grad()
def run_static(args, cfg, params, prompts: Optional[np.ndarray] = None, *,
               device=None, quiet: bool = False) -> np.ndarray:
    """The static (non-paged) mode: one batch of prompts (``prompts``, or
    :func:`static_prompts`), one prefill and ``args.gen - 1`` batched
    greedy decode steps over the dense (batch, prompt_len + gen) cache
    (the reference's ``src/repro/launch/serve.py:263``). ``params`` are
    cast (or already quantized) as the engine serves them. Returns the
    (batch, gen) int32 tokens."""
    dev = resolve_device(device if device is not None else args.device)
    if prompts is None:
        prompts = static_prompts(args, cfg.vocab)
    prompts = np.asarray(prompts, dtype=np.int32)
    batch, plen = prompts.shape
    max_seq = plen + args.gen
    params = serving_params(params, cfg, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.time()
    logits, state, _ = _static_start(cfg, params, prompts, max_seq, batch, dev)
    tok = torch.argmax(logits[:, -1], dim=-1)
    sync()
    t_prefill = time.time() - t0
    out = [tok.cpu()]
    t0 = time.time()
    for i in range(args.gen - 1):
        logits, state = _static_step(cfg, params, tok.cpu().numpy(), state, plen + i, batch,
                                     dev)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok.cpu())
    sync()
    t_decode = time.time() - t0
    gen = torch.stack(out, dim=1).numpy().astype(np.int32)
    if not quiet:
        print(f"prefill: {t_prefill * 1e3:.1f} ms for {batch}x{plen} tokens")
        print(f"decode:  {t_decode / max(args.gen - 1, 1) * 1e3:.2f} ms/token "
              f"({batch} sequences)")
        print("generated token ids (first sequence):", gen[0][:16], "...")
    return gen


def verify_static_int8(args, cfg, qparams, prompts, gen_q) -> None:
    """``--quantize int8 --verify`` in static mode: the int8 tokens
    against the static path over the dequantized weights, token for token
    in fp32 compute, within the ladder teacher-forced in bf16."""
    dev = resolve_device(args.device)
    dequant = dequantize_tree(qparams)
    if compute_dtype(cfg) == torch.float32:
        gen_ref = run_static(args, cfg, dequant, prompts, quiet=True)
        if not np.array_equal(gen_q, gen_ref):
            bad = int(np.sum(np.any(gen_q != gen_ref, axis=1)))
            raise SystemExit(f"{bad}/{len(prompts)} sequences: int8 path diverged from "
                             f"the fp32 static path over dequantized weights")
        print(f"verify: all {len(prompts)} sequences match the fp32 static path over the "
              f"dequantized weights token-for-token")
        return
    worst, exact, total = 0.0, 0, 0
    for b, prompt in enumerate(prompts):
        gaps = static_logit_gaps(cfg, dequant, prompt, gen_q[b], prompt.shape[0] + args.gen,
                                 device=dev)
        worst = max(worst, float(gaps.max()))
        exact += int(np.sum(gaps == 0.0))
        total += len(gaps)
        if gaps.max() > 1.0:
            first = int(np.argmax(gaps > 1.0))
            raise SystemExit(f"verify failed: sequence {b}: token {first} is "
                             f"{gaps[first]:.3f}x the ladder's allowance below the static "
                             f"path's best logit over the dequantized weights")
    print(f"verify: every token of all {len(prompts)} sequences lies within the {cfg.dtype} "
          f"ladder of the static path over the dequantized weights, teacher-forced "
          f"(largest gap {worst:.3f} of the allowance); {exact}/{total} tokens are exactly "
          f"its choice")


def verify(engine: ServingEngine, trace, out, params) -> None:
    """Check every request within the identity horizon against the static
    path over the engine's own weights: identical tokens in fp32
    compute, :func:`check_oracles` in bf16. Under --quantize, print the
    agreement with the dequantized and the unquantized weights as
    diagnostics."""
    cfg, pcfg = engine.cfg, engine.pcfg
    horizon = (identity_horizon(engine.streaming, pcfg)
               if engine.streaming is not None else None)
    checked = [r for r in trace
               if horizon is None or r.prompt_len + r.max_new_tokens <= horizon]
    skipped = len(trace) - len(checked)
    note = (f" ({skipped} beyond the {horizon}-token streaming identity horizon skipped)"
            if skipped else "")
    if compute_dtype(cfg) == torch.float32:
        bad = 0
        for r in checked:
            ref = static_greedy_reference(cfg, engine.params, r.prompt, r.max_new_tokens,
                                          pcfg.max_seq, device=engine.device,
                                          rows=static_rows(engine),
                                          page_size=static_page_size(engine))
            got = out[r.rid]
            ok = (np.array_equal(ref[:len(got)], got)
                  if engine.last_statuses.get(r.rid) != "finished"
                  else np.array_equal(ref, got))
            if not ok:
                bad += 1
                print(f"request {r.rid}: MISMATCH\n  static {ref}\n  paged  {got}")
        if bad:
            raise SystemExit(f"{bad}/{len(checked)} requests diverged from the static path")
        print(f"verify: all {len(checked)} requests match the static path token-for-token"
              + note)
    else:
        try:
            rep = check_oracles(engine, checked, out, checked)
        except AssertionError as e:
            raise SystemExit(f"verify failed: {e}") from None
        print(f"verify: all {rep['alone']} requests match the request served alone bit for "
              f"bit, and every token lies within the {cfg.dtype} ladder of the static path, "
              f"teacher-forced (largest gap {rep['max_gap']:.3f} of the allowance); "
              f"{rep['exact']}/{rep['tokens']} tokens are exactly the static path's choice"
              + note)
    if engine.quantize:
        for what, oracle in (("the dequantized int8 weights", dequantize_tree(engine.params)),
                             ("the unquantized weights", params)):
            agree = total = 0
            for r in checked:
                ref = static_greedy_reference(cfg, oracle, r.prompt, r.max_new_tokens,
                                              pcfg.max_seq, device=engine.device)
                agree += int(np.sum(ref[:len(out[r.rid])] == out[r.rid]))
                total += ref.size
            print(f"diagnostic: {agree}/{total} greedy tokens agree with {what}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static mode: sequences in the batch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="use the paged KV cache (serving/paged_cache.py)")
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching over a staggered request trace")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4, help="decode slots")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--arrive-every", type=int, default=4,
                    help="engine steps between arrival waves")
    ap.add_argument("--prefill-budget", type=int, default=64,
                    help="max prefill tokens per engine step (with "
                         "--chunked-prefill, also the chunk size)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across requests")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="split prompt prefill into budget-sized chunks "
                         "interleaved with decode steps")
    ap.add_argument("--request-timeout", type=int, default=None,
                    help="per-request deadline in engine steps")
    ap.add_argument("--scheduler", choices=["fifo", "slo"], default="fifo",
                    help="admission policy: fifo (arrival order) or slo (per-tenant fair "
                         "share, priority, earliest deadline; doomed requests shed)")
    ap.add_argument("--speculative-rank", default=None,
                    help="self-speculative decoding (not ported: ROADMAP queue 1 item 6)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel decode devices (above 1 not ported: ROADMAP "
                         "queue 1 item 8)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill on a separate worker (not ported: ROADMAP queue 1 item 8)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to "
                         "every request")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="serve int8 per-channel quantized weights (spectral factors "
                         "and dense projections)")
    ap.add_argument("--streaming-window", type=int, default=None,
                    help="long-context streaming: keep this many sliding-window pages "
                         "(plus the pinned sinks) resident per sequence")
    ap.add_argument("--sink-pages", type=int, default=1,
                    help="attention-sink pages pinned at the head of every sequence "
                         "(with --streaming-window)")
    ap.add_argument("--cold-kv", choices=["none", "int8"], default="none",
                    help="tier of resident pages older than the window: none keeps "
                         "them bf16, int8 demotes them to int8 shadow pools (with "
                         "--streaming-window)")
    ap.add_argument("--verify", action="store_true",
                    help="check outputs against the static path: token for token in "
                         "fp32; in bf16, each request equal to itself served alone and "
                         "every token within the ladder of the static path; static "
                         "mode with --quantize int8: the int8 tokens against the static "
                         "path over the dequantized weights")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest training checkpoint under this directory "
                         "instead of random weights")
    ap.add_argument("--serve-rank", type=int, default=None,
                    help="resize spectral groups at load (not ported: ROADMAP queue 1 "
                         "item 9)")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved RunSpec JSON and exit")
    return ap


def build_spec(args: argparse.Namespace) -> RunSpec:
    """argparse Namespace -> RunSpec, as the reference's CLI builds it.
    The trace's shape (--requests, --arrive-every, --shared-prefix,
    --seed) stays on the CLI: it describes the workload, not the
    runtime."""
    return RunSpec(
        model=ModelSpec(arch=args.arch, reduced=args.reduced),
        serve=ServeSpec(
            mode="paged" if args.paged else "static",
            slots=args.slots, page_size=args.page_size, num_pages=args.num_pages,
            pages_per_seq=args.pages_per_seq, prefill_budget=args.prefill_budget,
            prefix_cache=args.prefix_cache, chunked_prefill=args.chunked_prefill,
            request_timeout=args.request_timeout, scheduler=args.scheduler,
            quantize=args.quantize, rank=args.serve_rank, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            speculative_rank=args.speculative_rank, disaggregate=args.disaggregate,
            streaming=StreamingSpec(sink_pages=args.sink_pages,
                                    window_pages=args.streaming_window,
                                    cold_kv=args.cold_kv)),
        sharding=ShardingSpec(decode_mesh=args.tp if args.tp > 1 else None),
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.paged != args.stream:
        raise SystemExit("--paged and --stream go together (static mode: neither)")
    for flag, given, item in (("--serve-rank", args.serve_rank is not None, 9),
                              ("--speculative-rank", args.speculative_rank is not None, 6),
                              ("--disaggregate", args.disaggregate, 8),
                              ("--tp above 1", args.tp > 1, 8)):
        if given:
            raise SystemExit(f"{flag} is not ported (ROADMAP queue 1 item {item})")
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp} must be >= 1")
    if args.streaming_window is not None and not args.paged:
        raise SystemExit("--streaming-window needs --paged --stream")
    if args.streaming_window is None and args.cold_kv != "none":
        raise SystemExit("--cold-kv needs --streaming-window")
    if args.streaming_window is not None:
        cap = args.sink_pages + args.streaming_window + 1
        if args.sink_pages < 1 or args.streaming_window < 1:
            raise SystemExit("--sink-pages and --streaming-window must be >= 1")
        if cap > args.pages_per_seq:
            raise SystemExit(f"streaming resident cap {cap} pages (sink + window + "
                             f"growth) exceeds --pages-per-seq {args.pages_per_seq}")
    spec = build_spec(args)
    if args.dump_spec:
        print(spec.to_json(indent=2))
        return
    cfg = spec.model.config()
    cap = decode_capacity_binds(cfg, args.slots)
    if args.paged and args.verify and cap is not None:
        raise SystemExit(
            f"--verify: {cfg.name}'s decode step gives each expert a capacity of {cap} "
            f"tokens (capacity_factor {cfg.capacity_factor} x {args.slots} slots x top_k "
            f"{cfg.top_k} / {cfg.n_experts} experts), below the {args.slots} slots: the "
            f"engine's batched step then drops other tokens than the static path, and the "
            f"token identity --verify checks does not hold. The reference's own tests pin "
            f"capacity_factor=8.0, where capacity does not bind.")
    if not args.paged and args.verify and not args.quantize:
        raise SystemExit("--verify needs --paged --stream or --quantize int8")
    if args.ckpt_dir:
        try:
            step, params = params_from_checkpoint(args.ckpt_dir,
                                                  device=resolve_device(args.device))
        except FileNotFoundError as e:
            raise SystemExit(str(e))
        print(f"loaded checkpoint step {step} from {args.ckpt_dir}")
    else:
        params = init_model(cfg, seed=args.seed, device=args.device)
    if args.paged:
        run_stream(args, spec, params)
        return
    dev = resolve_device(args.device)
    if args.quantize:
        qparams = serving_params(params, cfg, dev, quantize=args.quantize)
        print(f"weights: {param_bytes(qparams)} bytes {args.quantize} "
              f"(fp32 {param_bytes(params)} bytes, "
              f"{param_bytes(params) / param_bytes(qparams):.2f}x smaller)")
        prompts = static_prompts(args, cfg.vocab)
        gen_q = run_static(args, cfg, qparams, prompts)
        if args.verify:
            verify_static_int8(args, cfg, qparams, prompts, gen_q)
    else:
        run_static(args, cfg, params)


if __name__ == "__main__":
    main()
