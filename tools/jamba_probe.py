#!/usr/bin/env python3
"""Probe, on a GPU, why jamba's static path needs the engine's paged
decode to check the engine in bf16; or time jamba's prompt path.

    python3 tools/jamba_probe.py
    python3 tools/jamba_probe.py --prefill [--src DIR]

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

With ``--prefill``: the same model's prefill of the trace's longest prompt
(160 tokens, ``chip_smoke.py``'s ``prefill_160_ms``): its host-clock ms
(median of five, each ending in a device sync), and from one profiled
prefill the device time of all its kernels and of the scan's, and the
device kernels it runs. ``--src DIR`` imports the port from another
checkout's ``src`` (a ``git archive`` of an earlier tree), so that two
trees can be timed in one call.

Needs the repository around it and a CUDA device; imports no JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def prefill_mode(cs, dev) -> int:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import init_decode_state, init_model, prefill
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    print(f"[prefill] port from {Path(build.__file__).resolve().parents[2]}")
    cfg = get_config(cs.JAMBA_ARCH).replace(capacity_factor=cs.JAMBA_CAPACITY)
    pcfg = PagedCacheConfig(page_size=cs.PAGE, num_pages=cs.NUM_PAGES, max_slots=cs.SLOTS,
                            max_pages_per_seq=cs.PAGES_PER_SEQ)
    engine = ServingEngine(cfg, init_model(cfg, seed=cs.SEED, device=dev), pcfg, device=dev,
                           prefill_token_budget=64)
    long = max(cs.make_trace(cfg.vocab, cs.SEED), key=lambda r: r.prompt_len)
    toks = torch.as_tensor(long.prompt, dtype=torch.int64, device=dev)[None]

    def run():
        prefill(engine.params, toks, cfg, init_decode_state(cfg, 1, long.prompt_len, device=dev))

    times = []
    with torch.no_grad():
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    rows = cs.device_rows(torch, prof)
    scan = [(ms, n) for ms, n, key in rows if "mamba_scan" in key]
    print(f"[prefill] one {long.prompt_len}-token prefill: {sorted(times[2:])[2]:.2f} ms host "
          f"clock (median of 5 after 2 warm), device {sum(ms for ms, _, _ in rows):.3f} ms in "
          f"{sum(n for _, n, _ in rows)} kernels; the scan {sum(ms for ms, _ in scan):.3f} ms "
          f"in {sum(n for _, n in scan)} launches")
    return 0


def main() -> int:
    if "--src" in sys.argv:
        sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--src") + 1]).resolve()))
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
    if "--prefill" in sys.argv:
        return prefill_mode(cs, dev)
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
