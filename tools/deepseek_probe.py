#!/usr/bin/env python3
"""Probe, on a GPU, where deepseek's bf16 engine and its static path part.

    python3 tools/deepseek_probe.py
    PYTHONPATH=src python3 tools/deepseek_probe.py --reduced --device cpu   # a dry run

deepseek-v3-671b at full width cut to 8 layers (``chip_smoke.py``'s cell:
random weights from seed 0, capacity factor 32.0) serves
``chip_smoke.py``'s trace through the engine. Then, for every request:

- the prefill: the engine's chunk path (absorbed attention in bf16)
  against the static prefill (attention over K/V expanded from the
  latent): the static path's top-2 margin and the engine's first token's
  gap to its best logit, in units of the bf16 allowance;
- the static path teacher-forced over the engine's tokens in three
  readings: one row over its static cache (``rows=1``, fp32 attention),
  the engine's slot count over its static cache, and the engine's slot
  count through the paged decode in the engine's page geometry. For each,
  the largest gap, the tokens exactly its choice, and the (decode step,
  MoE layer) pairs at which row 0's top-8 experts differ from the
  reading at one row;
- the free-running static path in the same three readings: how many
  requests equal the engine's tokens, and where the first one parts.

Needs the repository around it and a CUDA device (``--device cpu`` with
``--reduced`` rehearses it on the CPU); imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None) -> int:
    import chip_smoke as cs
    from repro_torch.kernels.testing import tolerance_for
    from repro_torch.launch.serve import static_greedy_reference, static_logit_gaps
    from repro_torch.models.model import (
        init_decode_state,
        init_model,
        init_paged_state,
        prefill,
        prefill_chunk_paged,
    )
    from repro_torch.nn import moe
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("deepseek_probe: needs a CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.nvidia_smi())
    cfg = cs.deepseek_config(cs.DEEPSEEK_LAYERS)
    if args.reduced:
        from repro_torch.config import get_config

        cfg = get_config(cs.DEEPSEEK_ARCH, reduced=True).replace(capacity_factor=8.0)
    pcfg = PagedCacheConfig(page_size=cs.PAGE, num_pages=cs.NUM_PAGES, max_slots=cs.SLOTS,
                            max_pages_per_seq=cs.PAGES_PER_SEQ)
    engine = ServingEngine(cfg, init_model(cfg, seed=cs.SEED, device=dev), pcfg, device=dev,
                           prefill_token_budget=64)
    params = engine.params
    trace = cs.make_trace(cfg.vocab, cs.SEED)
    out = engine.run(trace)
    tol = tolerance_for(torch.bfloat16)
    readings = {"1 row": dict(rows=1), f"{cs.SLOTS} rows": dict(rows=cs.SLOTS),
                f"{cs.SLOTS} rows, paged": dict(rows=cs.SLOTS, page_size=cs.PAGE)}

    routes = []
    top_k = moe.top_k

    def recording_top_k(probs, k):
        vals, idx = top_k(probs, k)
        routes.append(idx[:1].clone())       # row 0 (the prompt's first token in prefill)
        return vals, idx

    n_moe = cfg.n_layers - cfg.first_dense_layers
    exact_free = dict.fromkeys(readings, 0)
    with torch.no_grad():
        for r in trace:
            toks = torch.as_tensor(r.prompt, dtype=torch.int64, device=dev)[None]
            static, _ = prefill(params, toks, cfg,
                                init_decode_state(cfg, 1, pcfg.max_seq, device=dev))
            bt = torch.arange(pcfg.max_pages_per_seq, dtype=torch.int32, device=dev)[None]
            chunk, _ = prefill_chunk_paged(params, toks, init_paged_state(cfg, pcfg, device=dev),
                                           bt, 0, cfg)
            ls, lc = static[0, -1].float(), chunk[0, -1].float()
            top2 = torch.topk(ls, 2).values
            allow = tol.atol * torch.sqrt(torch.mean(ls * ls)) + tol.rtol * top2[0].abs()
            tok = int(torch.argmax(lc))
            print(f"request {r.rid} ({r.prompt_len}-token prompt): prefill first token "
                  f"engine {tok} static {int(torch.argmax(ls))}; static top-2 margin "
                  f"{float((top2[0] - top2[1]) / allow):.3f} of the allowance, engine's token "
                  f"{float((top2[0] - ls[tok]) / allow):.3f} below the static best; chunk vs "
                  f"static logits max gap {float((lc - ls).abs().max() / allow):.3f}")
            moe.top_k = recording_top_k
            try:
                base = None
                for name, kw in readings.items():
                    routes.clear()
                    gaps = static_logit_gaps(cfg, params, r.prompt, out[r.rid], pcfg.max_seq,
                                             device=dev, **kw)
                    rt = torch.cat(routes).cpu().numpy()
                    if base is None:
                        base = rt
                    # the first n_moe records are the prefill's, then n_moe a step
                    diff = (np.sort(rt, -1) != np.sort(base, -1)).any(-1)
                    diff = diff.reshape(len(gaps), n_moe)[1:]
                    first = int(np.argmax(diff.any(1))) + 1 if diff.any() else None
                    free = static_greedy_reference(cfg, params, r.prompt, r.max_new_tokens,
                                                   pcfg.max_seq, device=dev, **kw)
                    same = np.array_equal(free, out[r.rid])
                    exact_free[name] += int(same)
                    part = None if same else int(np.argmax(free != out[r.rid]))
                    print(f"  {name}: teacher-forced largest gap {gaps.max():.3f}, "
                          f"{int((gaps == 0).sum())}/{len(gaps)} exact; top-8 differs from 1 "
                          f"row at {int(diff.sum())} of {diff.size} (step, MoE layer) pairs, "
                          f"first at decode step {first}; free-running "
                          f"{'== engine' if same else f'parts at token {part}'}")
            finally:
                moe.top_k = top_k
    print(f"free-running static path == engine, by reading: {exact_free} of {len(trace)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
