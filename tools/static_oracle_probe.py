#!/usr/bin/env python3
"""Probe, on a GPU, how far the port's static greedy path is from its
serving engine in bf16, and where the difference comes from.

    python3 tools/static_oracle_probe.py

1. Serves ``chip_smoke.py``'s 8-request trace (llama3.2-1b at full
   width, random weights from seed 0) with bf16 and with int8 weights,
   records the engine's logits at every decode step, then runs the
   static path teacher-forced over the engine's tokens. For every step
   where the static path's argmax is not the engine's token it prints
   (step, static choice, engine token, the static path's logits for
   both, the engine's logits for both).
2. Checks which operations compute a row the same way at another batch
   size: bf16 cuBLAS GEMMs at the decode shapes and the LM head, row by
   row against M = 1; and the static path's fp32 decode attention
   (``_sdpa`` over the gathered cache) against the paged decode kernel,
   output bits, over 26 cache lengths.

Needs the repository around it and a CUDA device; imports no JAX.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def engine_vs_static(cfg, device):
    import chip_smoke as cs
    from repro_torch.models.model import decode_step, init_decode_state, init_model, prefill
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    masters = init_model(cfg, seed=cs.SEED, device=device)
    pcfg = PagedCacheConfig(page_size=cs.PAGE, num_pages=cs.NUM_PAGES, max_slots=cs.SLOTS,
                            max_pages_per_seq=cs.PAGES_PER_SEQ)
    for quantize in (None, "int8"):
        engine = ServingEngine(cfg, masters, pcfg, device=device, prefill_token_budget=64,
                               quantize=quantize)
        engine.run(cs.make_trace(cfg.vocab, cs.SEED + 3, rid0=len(cs.TRACE)))
        recorded = {}
        step = engine_mod.decode_step_paged

        def recording_step(*args, **kwargs):
            logits, state = step(*args, **kwargs)
            for slot, seq in engine.sched.active.items():
                if seq.status == "decoding":
                    recorded.setdefault(seq.request.rid, []).append(
                        logits[slot, -1].float().cpu())
            return logits, state

        engine_mod.decode_step_paged = recording_step
        trace = cs.make_trace(cfg.vocab, cs.SEED)
        try:
            out = engine.run(trace)
        finally:
            engine_mod.decode_step_paged = step
        for r in trace:
            got = out[r.rid]
            flips = []
            with torch.no_grad():
                state = init_decode_state(cfg, 1, pcfg.max_seq, device=device)
                toks = torch.as_tensor(r.prompt, dtype=torch.int64, device=device)[None]
                logits, state = prefill(engine.params, toks, cfg, state)
                for i, tok in enumerate(got.tolist()):
                    lg = logits[0, -1].float()
                    best = int(torch.argmax(lg))
                    if best != tok:
                        eng = recorded[r.rid][i - 1] if i > 0 else None
                        flips.append((i, best, tok, float(lg[best]), float(lg[tok]),
                                      None if eng is None else
                                      (float(eng[best]), float(eng[tok]))))
                    if i + 1 < len(got):
                        nxt = torch.tensor([[tok]], dtype=torch.int64, device=device)
                        logits, state = decode_step(engine.params, nxt, state,
                                                    r.prompt_len + i, cfg)
            print(f"{quantize or 'bf16'} request {r.rid}: {len(got)} tokens; static argmax "
                  f"!= engine token at (step, static, engine, static logits, engine "
                  f"logits): {flips}")
        del engine
        torch.cuda.empty_cache()


def row_invariance(device):
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.nn.attention import _sdpa
    from repro_torch.nn.embedding import apply_lm_head

    gen = torch.Generator(device=device).manual_seed(0)
    dt = torch.bfloat16
    for k, n in ((2048, 2048), (2048, 512), (2048, 128256)):
        for M in (4, 8, 160):
            x = torch.randn((M, k), generator=gen, device=device).to(dt)
            w = (torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)).to(dt)
            full = x @ w
            same = all(torch.equal((x[i:i + 1] @ w)[0], full[i]) for i in range(M))
            print(f"bf16 GEMM ({M},{k})@({k},{n}): every row equals M = 1: {same}")
    emb = {"w": (torch.randn((128256, 2048), generator=gen, device=device) * 0.02).to(dt)}
    x = torch.randn((4, 1, 2048), generator=gen, device=device).to(dt)
    full = apply_lm_head(emb, x)
    print("LM head rows equal M = 1:",
          all(torch.equal(apply_lm_head(emb, x[i:i + 1])[0], full[i]) for i in range(4)))
    kvh, rep, hd, page, n = 8, 4, 64, 16, 16
    S = page * n
    k = torch.randn((1, S, kvh, hd), generator=gen, device=device).to(dt)
    v = torch.randn((1, S, kvh, hd), generator=gen, device=device).to(dt)
    bt = torch.arange(n, device=device, dtype=torch.int32)[None]
    same = total = 0
    for length in range(20, 200, 7):
        q = torch.randn((1, 1, kvh * rep, hd), generator=gen, device=device).to(dt)
        valid = (torch.arange(S, device=device) <= length)[None]
        o_static = _sdpa(q.float(), k.float(), v.float(), causal=False,
                         kv_len_mask=valid).to(dt)
        o_paged = paged_gqa_decode(q[:, 0].reshape(1, kvh, rep, hd),
                                   k.reshape(n, page, kvh, hd), v.reshape(n, page, kvh, hd),
                                   bt, torch.tensor([length], device=device, dtype=torch.int32))
        same += int(torch.equal(o_static.reshape(-1), o_paged.reshape(-1)))
        total += 1
    print(f"decode attention, static fp32 SDPA vs the paged kernel, bf16 outputs "
          f"bit-equal on {same} of {total} lengths")


def main() -> int:
    if not torch.cuda.is_available():
        print("static_oracle_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    engine_vs_static(get_config("llama3.2-1b"), device)
    row_invariance(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
