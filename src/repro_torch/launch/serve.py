"""Serving launcher of the port: continuous batching over the paged KV
cache, replaying a staggered trace of variable-length requests.

  python -m repro_torch.launch.serve --arch llama3.2-1b --paged --stream --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --paged --stream --verify --device cpu

Runs on the CUDA device unless ``--device`` names another. The weights
are random, from ``--seed``. ``--verify`` replays every request through
the batch-1 static-cache greedy path (:func:`static_greedy_reference`)
and fails on any token mismatch.

The reference's static mode, int8, speculative, tensor-parallel,
disaggregated and streaming-window options are not ported yet.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import (
    decode_step,
    init_decode_state,
    init_model,
    prefill,
    serving_params,
)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged_cache import PagedCacheConfig
from repro_torch.serving.scheduler import Request


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


@torch.no_grad()
def static_greedy_reference(cfg, params, prompt, gen, max_seq, *, device=None):
    """Batch-1 static-cache greedy decode — the token-for-token oracle
    for --verify: the same spectral kernel as the engine, fp32 decode
    attention over the gathered static cache instead of the paged
    kernel. ``params`` are cast as the engine casts them (a no-op on
    an engine's own params)."""
    dev = resolve_device(device)
    params = serving_params(params, cfg, dev)
    state = init_decode_state(cfg, 1, max_seq, device=dev)
    tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64).to(dev)[None]
    logits, state = prefill(params, tokens, cfg, state)
    toks = [int(torch.argmax(logits[0, -1]))]
    for i in range(gen - 1):
        tok = torch.tensor([[toks[-1]]], dtype=torch.int64, device=dev)
        logits, state = decode_step(params, tok, state, len(prompt) + i, cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return np.asarray(toks, dtype=np.int32)


def paged_config(args) -> PagedCacheConfig:
    return PagedCacheConfig(page_size=args.page_size, num_pages=args.num_pages,
                            max_slots=args.slots, max_pages_per_seq=args.pages_per_seq)


def run_stream(args, cfg, params) -> ServingEngine:
    pcfg = paged_config(args)
    engine = ServingEngine(cfg, params, pcfg, device=args.device,
                           prefill_token_budget=args.prefill_budget,
                           prefix_cache=args.prefix_cache,
                           chunked_prefill=args.chunked_prefill)
    trace = build_trace(args, cfg.vocab, pcfg)
    print(f"streaming {len(trace)} requests, prompt lens "
          f"{sorted({r.prompt_len for r in trace})}, slots={pcfg.max_slots}, "
          f"pool={pcfg.num_pages}x{pcfg.page_size} tokens, device={engine.device}")
    out = engine.run(trace)
    engine.sched.check_invariants()
    st = engine.stats()
    print(f"served {int(st['requests'])} requests: "
          f"{int(st['prefill_tokens'])} prefill + {int(st['generated_tokens'])} generated "
          f"tokens in {st['wall_s']:.2f}s ({st['tokens_per_s']:.1f} tok/s)")
    print(f"paged attention cache: {int(st['attn_cache_bytes'])} bytes "
          f"({pcfg.num_pages}+1 pages x {pcfg.page_size} tokens)")
    if args.prefix_cache:
        saved, total = int(st["prefix_shared_tokens"]), int(st["prompt_tokens"])
        print(f"prefix cache: {saved}/{total} prompt tokens served from cache")
    print(f"inter-token latency: p50 {st['itl_p50_s'] * 1e3:.1f} ms, "
          f"p99 {st['itl_p99_s'] * 1e3:.1f} ms")
    print("generated token ids (request 0):", out[trace[0].rid][:16], "...")
    if args.verify:
        bad = 0
        for r in trace:
            ref = static_greedy_reference(cfg, engine.params, r.prompt, r.max_new_tokens,
                                          pcfg.max_seq, device=engine.device)
            got = out[r.rid]
            ok = (np.array_equal(ref[:len(got)], got)
                  if engine.last_statuses.get(r.rid) != "finished"
                  else np.array_equal(ref, got))
            if not ok:
                bad += 1
                print(f"request {r.rid}: MISMATCH\n  static {ref}\n  paged  {got}")
        if bad:
            raise SystemExit(f"{bad}/{len(trace)} requests diverged from the static path")
        print(f"verify: all {len(trace)} requests match the static path token-for-token")
    return engine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "kernels' plain versions)")
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
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to "
                         "every request")
    ap.add_argument("--verify", action="store_true",
                    help="check outputs against the static path token for token")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.paged and args.stream):
        raise SystemExit("the port serves with --paged --stream (static mode is "
                         "not ported)")
    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_model(cfg, seed=args.seed, device=args.device)
    run_stream(args, cfg, params)


if __name__ == "__main__":
    main()
