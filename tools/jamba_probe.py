#!/usr/bin/env python3
"""Probe, on a GPU, why jamba's static path needs the engine's paged
decode to check the engine in bf16.

    python3 tools/jamba_probe.py

jamba-v0.1-52b at full width (random weights from seed 0, capacity
factor 8.0) serves ``chip_smoke.py``'s trace through the engine. Then,
for requests 0-3, the static path runs teacher-forced over the engine's
tokens at the engine's slot count twice: with fp32 attention over its
static cache (``page_size=None``) and through the paged decode in the
engine's page geometry (``static_page_size``). Prints, for each, the
largest gap to the engine's token (in units of the bf16 allowance) and
how many tokens are exactly the static path's choice, and the number of
(decode step, MoE layer) pairs at which row 0's top-2 experts differ
between the two runs, with the first such step.

Needs the repository around it and a CUDA device; imports no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.launch.serve import static_logit_gaps, static_page_size, static_rows
    from repro_torch.models.model import init_model
    from repro_torch.nn import moe
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    if not torch.cuda.is_available():
        print("jamba_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi())
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.JAMBA_ARCH).replace(capacity_factor=cs.JAMBA_CAPACITY)
    pcfg = PagedCacheConfig(page_size=cs.PAGE, num_pages=cs.NUM_PAGES, max_slots=cs.SLOTS,
                            max_pages_per_seq=cs.PAGES_PER_SEQ)
    engine = ServingEngine(cfg, init_model(cfg, seed=cs.SEED, device=dev), pcfg, device=dev,
                           prefill_token_budget=64)
    trace = cs.make_trace(cfg.vocab, cs.SEED)
    out = engine.run(trace)

    routes = []
    top_k = moe.top_k

    def recording_top_k(probs, k):
        vals, idx = top_k(probs, k)
        routes.append(idx[:1].clone())       # row 0 (the prompt's first token in prefill)
        return vals, idx

    moe.top_k = recording_top_k
    try:
        for r in trace[:4]:
            res = {}
            for page_size in (None, static_page_size(engine)):
                routes.clear()
                gaps = static_logit_gaps(cfg, engine.params, r.prompt, out[r.rid],
                                         pcfg.max_seq, device=dev, rows=static_rows(engine),
                                         page_size=page_size)
                res[page_size] = (gaps, torch.cat(routes).cpu().numpy())
            (ga, ra), (gb, rb) = res.values()
            n_moe = ra.shape[0] // len(ga)
            # the first n_moe rows are the prefill's; row 0 leads a decode step
            diff = (ra != rb).any(-1).reshape(len(ga), n_moe)[1:]
            first = int(np.argmax(diff.any(1))) + 1 if diff.any() else None
            print(f"request {r.rid} ({r.prompt_len}-token prompt, {len(ga)} tokens): fp32 "
                  f"attention over the cache: largest gap {ga.max():.3f}, "
                  f"{int((ga == 0).sum())} exact; paged decode: largest gap {gb.max():.3f}, "
                  f"{int((gb == 0).sum())} exact; row 0's top-2 differs at "
                  f"{int(diff.sum())} of {diff.size} (step, MoE layer) pairs, first at "
                  f"decode step {first}")
    finally:
        moe.top_k = top_k
    return 0


if __name__ == "__main__":
    sys.exit(main())
