#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold every kernel against its plain PyTorch version on the card,
   under the tolerance ladder (fp32 5e-5, bf16 5e-2, on outputs scaled
   by the reference's RMS), at the main paths' shapes in bf16 and fp32:
   the decode shapes, and the training shapes (flash forward and
   backward, the spectral autograd Function at M = 8192);
3. serve llama3.2-1b at full width (16 layers, d_model 2048, 32/8
   heads, d_ff 8192, vocab 128256, rank 128, bf16; random weights from
   seed 0) through ``ServingEngine``: one warm-up trace, then the
   measured staggered 8-request trace, with the kernel launch counts
   zeroed just before it and read just after; replay two requests
   through ``static_greedy_reference`` and require identical tokens;
4. time each kernel, its plain version and a library call computing the
   same function at the decode shapes, in device time only;
5. trace a decode-heavy stretch of serving with ``torch.profiler`` and
   print device time by kernel and the device's busy share of the wall
   clock;
6. train smollm2-1.7b at full width (24 layers, d_model 2048, 32/32
   heads, d_ff 8192, vocab 49152, rank 128, QR retraction, remat, bf16
   compute over fp32 masters; batch 2 x 4096 tokens; random weights from
   seed 0) through ``Trainer`` for 8 steps, with the launch counts
   zeroed just before each step and read just after: every step must
   launch the flash forward 48 times (forward and remat recompute), the
   flash backward 24 times and the spectral kernel 144 times; losses
   finite, orthogonality error <= 1e-4, every gradient leaf finite and
   non-zero; then trace one more warm step with ``torch.profiler``;
7. resume a reduced run from its step-3 checkpoint on the card and
   require the losses of steps 4-6 and the final parameters bit-identical
   to an uninterrupted run;
8. time the flash kernels and the spectral kernel at the training
   shapes against their plain versions, SDPA and the three-GEMM chain;
9. hold the int8 kernels against their plain versions: the int8
   spectral matmul at M in {1, 4, 37, 64, 256} on both MLP shapes under
   every scale profile of the JAX package's tests, with every row of
   M = 37 bit-identical to the row alone; the cold-aware paged decode at
   p_cold in {0, 0.5, 1} (shadows uncorrelated with the pools, ragged
   lengths, shuffled tables, a null-page slot), bit-identical to the hot
   kernel with no page flagged;
10. serve llama3.2-1b at full width with int8 weights on phase 3's trace
    and geometry: the int8 spectral kernel launched 48 times per decode
    step and prefill chunk, the bf16 one never; every request's tokens
    equal the request served alone by a fresh engine (bit for bit) and
    stay within the tolerance ladder of the static greedy path over the
    same int8 tree, teacher-forced (in bf16 the static path's attention
    sums in another order, so a near-tie can go the other way: exact
    identity with it is printed, not required); the agreement with the
    dequantized and the unquantized weights is printed;
11. stream llama3.2-1b at full width with int8 weights and the int8 cold
    tier (page 16, 32 pages, 4 slots, sink 1, window 4): four long
    requests far past the resident cap and four within the identity
    horizon, twice; both runs give the same tokens and the same
    eviction/demotion ledger, the short requests and the first long one
    equal their replays alone, the short ones stay within the ladder of
    the static path, the cold
    kernel is launched 16 times a decode step and the hot one never, and
    one layer's real pools snapshotted mid-session with cold pages
    flagged give the cold kernel's plain version's output;
12. time both int8 kernels at the decode shapes (and the int8 matmul at
    a 64-token prefill chunk) against their plain versions and a library
    yardstick; profile a decode-heavy stretch of each new serving cell
    as in phase 5;
13. hold the chunkwise mLSTM kernel against its plain version (cut into
    the kernel's 64-token chunks) at head widths 32 and 1024, B = batch
    x heads 1 and 4, S in {1, 37, 64, 160, 256, 300, 1000}, two gate
    profiles (unit, and one that drives the stabiliser: i in [-20, 20],
    f at either saturation), with and without an initial state: y, C, n
    and m at the fp32 rung; and the spectral kernel at xlstm's four
    projection shapes (2048->8192, 4096->2048, 2048->5460, 2730->2048);
14. serve xlstm-1.3b at full width (48 blocks: 6 periods of 7 mLSTM + 1
    sLSTM, d_model 2048, 4 heads of 1024 in the mLSTM, vocab 50304, rank
    128, bf16; random weights from seed 0) on phase 3's trace and
    geometry: the mLSTM kernel launched 42 times per prefilled request and
    never in decode, the spectral kernel 96 times per model forward;
    every request equals the request served alone (bit for bit) and
    stays within the ladder of the static path, teacher-forced; profile
    a decode-heavy stretch as in phase 5;
15. time the mLSTM kernel and its plain version at the cell's prefill
    shape (one 160-token prompt: 4 heads x 1024);
16. hold the selective-scan kernel against its plain version: b in {1,
    2}, S in {1, 3, 37, 64, 160, 512, 1000}, di in {128, 200, 8192}, fp32
    and bf16 inputs, two dt profiles (unit, and one that drives dt * A to
    -30): y and the final state at the fp32 rung (the kernel computes the
    plain version's fp32 operations in its order, so a bf16 y rounds
    from the same value); print the bf16 gap to the reference model's
    scan, which carries h in bf16 (not gated); hold the spectral kernel at
    jamba's MLP shapes (rank 256, M in {4, 160}) and the paged decode at
    head dim 128 (b 4, kvh 8, rep 4, ragged lengths, a null-page slot),
    bf16 and fp32;
17. serve jamba-v0.1-52b at full width (32 layers: 4 periods of 7 mamba +
    1 attention, MoE of 16 experts top-2 on every other layer, d_model
    4096, 32/8 heads of 128, d_ff 14336, vocab 65536, rank 256, bf16;
    random weights from seed 0; capacity factor 8.0, the JAX package's
    tests' pin) on phase 3's trace and geometry: the scan kernel launched
    28 times per prefilled request and never in decode, the spectral
    kernel 48 times per model forward, the paged decode 4 times per
    decode step, the flash kernels never; every request equals the
    request served alone (bit for bit) and stays within the ladder of the
    static path, teacher-forced; weight, recurrent-state and peak device
    bytes printed; profile a decode-heavy stretch as in phase 5;
18. time the scan kernel and its plain version at one 160-token prompt's
    mamba layer (b 1, di 8192, d_state 16, bf16).

Every entry of the ``kernels`` line carries ``max_scaled_err``: the
largest error of its checks divided by the reference's RMS, the figure
the ladder's rung bounds (``max_abs_err`` and ``max_err`` are unscaled).

The last line is ``{"ok": true, "device": {...}}``. The script needs
the repository around it: alone, or without a CUDA device, it fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM: HBM3 bandwidth and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
SPIN_CYCLES = 1 << 21   # ~1 ms at the H100's 1.98 GHz: longer than queueing one call

# training: smollm2-1.7b at batch 2 x seq 4096 (train_4k's sequence length)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm2-1.7b", 2, 4096, 8
ORTHO_LIMIT = 1e-4
# flash kernel checks: (b, s, g, r, d) at the training shape, a grouped
# layout at the same length, and a ragged length
FLASH_CHECKS = [(2, 4096, 32, 1, 64), (1, 4096, 8, 4, 64), (1, 1000, 4, 4, 64)]

# the full-width trace: (prompt_len, max_new_tokens), four per arrival wave
TRACE = [(32, 16), (160, 32), (75, 24), (118, 20), (47, 28), (140, 18), (96, 32), (60, 24)]
SLOTS, PAGE, NUM_PAGES, PAGES_PER_SEQ, ARRIVE_EVERY = 4, 16, 96, 16, 4
REPLAYS = (0, 1)

# int8 kernel checks: batch sizes and the JAX package's scale profiles
Q8_ROWS = (1, 4, 37, 64, 256)
Q8_PREFILL_M = 64
# the streaming cell: int8 weights + int8 cold KV, four long requests far
# past the resident cap (sink + window + 1 = 6 pages: 18-23 pages each,
# 160-192 new tokens, cut from 448-512 to keep the run's time) and four
# within the identity horizon ((sink + window) x page = 80 tokens), two
# per wave; the short ones and the first long one are replayed alone
STREAM_SLOTS, STREAM_PAGES, STREAM_PAGES_PER_SEQ, SINK, WINDOW = 4, 32, 8, 1, 4
STREAM_TRACE = [(96, 192, 0), (32, 40, 0), (128, 176, 0), (24, 48, 0),
                (160, 160, 4), (40, 36, 4), (192, 176, 4), (16, 56, 4)]
SNAPSHOT_STEP = 150

# the xlstm cell: xlstm-1.3b at full width on slice 1's trace and geometry
XLSTM_ARCH = "xlstm-1.3b"
# mLSTM kernel checks: head widths (the reduced config's 32, xlstm-1.3b's
# 1024), folded batch * heads, prompt lengths (ragged 64-token chunks, one
# token, the cell's longest prompt, two chunks of the reference's 256)
MLSTM_DH, MLSTM_B, MLSTM_S = (32, 1024), (1, 4), (1, 37, 64, 160, 256, 300, 1000)
MLSTM_PREFILL_S = 160           # the cell's longest prompt: the timed shape

# the jamba cell: jamba-v0.1-52b at full width on slice 1's trace and
# geometry, at the capacity factor the JAX package's tests pin
JAMBA_ARCH, JAMBA_CAPACITY = "jamba-v0.1-52b", 8.0
# selective-scan checks: batch, prompt lengths (one token, ragged 32-step
# tiles, the cell's longest prompt, long), channels (one block, a ragged
# edge, jamba's 8192)
MAMBA_B, MAMBA_S, MAMBA_DI = (1, 2), (1, 3, 37, 64, 160, 512, 1000), (128, 200, 8192)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_cold(torch, fn, iters: int = 30) -> float:
    """Median device time of ``fn()`` in ms: CUDA events around each
    call, L2 flushed before each (the decode step finds each layer's
    weights cold: 1 GB of weights cycle through a 50 MB L2).

    A spin kernel is queued ahead of the flush, so the device reaches
    the start event only after the host has queued the whole call:
    the events then bracket device work alone, not host dispatch. A
    sample whose spin ended before the host was done is dropped and
    the spin doubled."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    spin = SPIN_CYCLES
    times = []
    while len(times) < iters:
        lead = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        lead.record()
        torch.cuda._sleep(spin)
        flush.zero_()
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if lead.elapsed_time(start) <= host_ms:
            if spin >= SPIN_CYCLES << 6:
                raise RuntimeError(f"time_cold: the host took {host_ms:.3f} ms to queue "
                                   "one call; the spin cannot cover it")
            spin *= 2
            continue
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ----------------------------------------------------------------- inputs --

def spectral_inputs(torch, M, m, n, k, dtype, gen):
    x = torch.randn((M, m), generator=gen, device="cuda").to(dtype)
    U = (torch.randn((m, k), generator=gen, device="cuda") / math.sqrt(m)).to(dtype)
    s = torch.rand((k,), generator=gen, device="cuda")
    V = (torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    return x, U, s, V


def paged_inputs(torch, seq_lens, n_pages, kvh, rep, hd, dtype, gen, *, null_slot):
    """Pools with random content everywhere (null page included), a
    shuffled block table whose rows end in null pages, and optionally
    slot 0 made an inactive null-page slot."""
    from repro_torch.kernels.testing import make_block_table

    b = len(seq_lens)
    num_pages = b * n_pages + 3
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    bt = make_block_table(b, n_pages, num_pages, sl.cpu(), PAGE, seed=SEED, device="cuda")
    if null_slot:
        bt[0, :] = num_pages
        sl[0] = 0
    shape = (num_pages + 1, PAGE, kvh, hd)
    k_pool = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((b, kvh, rep, hd), generator=gen, device="cuda").to(dtype)
    return q, k_pool, v_pool, bt, sl


# ----------------------------------------------------------------- phases --

def phase_build():
    from repro_torch.kernels import build

    t0 = time.time()
    build.library()
    print(f"[build] kernels built and loaded in {time.time() - t0:.1f} s "
          f"(nvcc {build.BUILD_LOG.get('seconds', 0.0):.1f} s)")
    for src, report in build.BUILD_LOG.get("ptxas", {}).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")


def phase_kernels(torch, cfg):
    """Kernel vs plain version on the card; returns {kernel: (max abs
    error, max RMS-scaled error)}."""
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.kernels.paged_ref import paged_gqa_decode_ref
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.kernels.testing import compare_kernel, ragged_seq_lens

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = cfg.sct.rank
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for m, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            for M in (1, 8, 37, 256):
                args = spectral_inputs(torch, M, m, n, k, dtype, gen)
                note(errs, "spectral_matmul", compare_kernel(
                    spectral_matmul, spectral_matmul_ref, args,
                    label=f"spectral_matmul {M}x{m}->{n} {dtype}"))
        n_pages = 12
        lens = ragged_seq_lens(8, PAGE * n_pages - 1, PAGE, seed=SEED).tolist()
        args = paged_inputs(torch, lens, n_pages, cfg.n_kv_heads,
                            cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, dtype, gen,
                            null_slot=True)
        # the null slot's output is one raw V row, larger than the live
        # slots' averages: compared on its own so it does not set their scale
        for part, what in ((slice(1, None), "live slots"), (slice(0, 1), "null slot")):
            note(errs, "paged_gqa_decode", compare_kernel(
                lambda *a: paged_gqa_decode(*a)[part], lambda *a: paged_gqa_decode_ref(*a)[part],
                args, label=f"paged_gqa_decode {dtype} {what}"))
        print(f"[kernels] {dtype}: spectral_matmul (M in 1/8/37/256, both MLP shapes) "
              f"and paged_gqa_decode (ragged lens {lens}, null slot) match")
    torch.cuda.synchronize()
    return errs


def make_trace(vocab, seed, rid0=0):
    import numpy as np
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=rid0 + i, prompt=rng.integers(0, vocab, size=(plen,)).astype(np.int32),
                    max_new_tokens=gen, arrival=i // SLOTS * ARRIVE_EVERY)
            for i, (plen, gen) in enumerate(TRACE)]


def phase_serving(torch, cfg, device):
    """Full-width serving through the engine; returns (engine, results)."""
    import numpy as np
    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.models.model import (
        init_decode_state,
        init_model,
        param_count,
        prefill,
    )
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    t0 = time.time()
    params = init_model(cfg, seed=SEED, device=device)
    n_params = param_count(params)
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=NUM_PAGES, max_slots=SLOTS,
                            max_pages_per_seq=PAGES_PER_SEQ)
    engine = ServingEngine(cfg, params, pcfg, device=device, prefill_token_budget=64)
    del params                                  # the engine holds its bf16 copy
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {n_params} parameters, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, rank {cfg.sct.rank}, "
          f"{cfg.dtype}; init + load {time.time() - t0:.1f} s")
    # warm-up: the same trace shape with other prompts pays the first-use
    # costs (cuBLAS handles, module loads) outside the measured run
    engine.run(make_trace(cfg.vocab, SEED + 3, rid0=len(TRACE)))
    trace = make_trace(cfg.vocab, SEED)
    before = engine.stats()
    print(f"[serve] warm-up run (cold): ITL p50 {before['itl_p50_s'] * 1e3:.3f} ms "
          f"p99 {before['itl_p99_s'] * 1e3:.3f} ms, {before['tokens_per_s']:.1f} tok/s")

    torch.cuda.reset_peak_memory_stats()
    out, launches, st = run_measured(torch, engine, trace)
    peak_mem = torch.cuda.max_memory_allocated()

    engine.sched.check_invariants()
    if engine.sched.pool.allocated_count != 0:
        raise AssertionError("pages still allocated after the trace")
    for name in ("spectral_matmul", "paged_gqa_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the main path never launched {name}: {launches}")
    for r in trace:
        got = out[r.rid]
        if (engine.last_statuses.get(r.rid) != "finished" or len(got) != r.max_new_tokens
                or got.min() < 0 or got.max() >= cfg.vocab):
            raise AssertionError(f"request {r.rid}: status "
                                 f"{engine.last_statuses.get(r.rid)}, tokens {got}")
    print(f"[serve] {int(st['requests'])} requests, {int(st['prefill_tokens'])} prefill + "
          f"{int(st['generated_tokens'])} generated tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']:.1f} tok/s), {int(st['decode_steps'])} decode steps, "
          f"{st['itl_gaps']} inter-token gaps, ITL p50 {st['itl_p50_s'] * 1e3:.3f} ms "
          f"p99 {st['itl_p99_s'] * 1e3:.3f} ms, peak pages {engine.peak_pages}, "
          f"launches {launches}")

    for rid in REPLAYS:
        r = trace[rid]
        ref = static_greedy_reference(cfg, engine.params, r.prompt, r.max_new_tokens,
                                      pcfg.max_seq, device=device)
        if not np.array_equal(ref, out[rid]):
            first = int(np.argmax(ref != out[rid]))
            raise AssertionError(f"request {rid}: engine tokens differ from the static "
                                 f"greedy reference at position {first}:\n  static "
                                 f"{ref}\n  engine {out[rid]}")
        print(f"[serve] request {rid} ({r.prompt_len}-token prompt, {r.max_new_tokens} "
              f"new): engine tokens == static greedy reference")

    # logits of the static path are finite and of the expected shape
    with torch.no_grad():
        state = init_decode_state(cfg, 1, pcfg.max_seq, device=device)
        toks = torch.as_tensor(trace[0].prompt, dtype=torch.int64, device=device)[None]
        logits, _ = prefill(engine.params, toks, cfg, state)
    if tuple(logits.shape) != (1, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    serving = {
        "arch": cfg.name, "params": n_params, "requests": int(st["requests"]),
        "prefill_tokens": int(st["prefill_tokens"]),
        "generated_tokens": int(st["generated_tokens"]),
        "decode_steps": int(st["decode_steps"]), "wall_s": st["wall_s"],
        "tokens_per_s": st["tokens_per_s"],
        "itl_gaps": st["itl_gaps"], "cold_itl_p50_ms": before["itl_p50_s"] * 1e3,
        "cold_itl_p99_ms": before["itl_p99_s"] * 1e3,
        "itl_p50_ms": st["itl_p50_s"] * 1e3, "itl_p99_ms": st["itl_p99_s"] * 1e3,
        "max_memory_allocated": peak_mem, "launches": launches,
        "replays_identical": len(REPLAYS),
    }
    return engine, trace, serving


def phase_timing(torch, cfg, engine, trace, launches, errs):
    """Kernel, plain and library times at the main path's decode shapes."""
    import torch.nn.functional as F
    from repro_torch.core.spectral import spectral_apply
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.kernels.paged_ref import paged_gqa_decode_ref
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.serving.paged_cache import paged_gather

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = torch.bfloat16
    k, d, f = cfg.sct.rank, cfg.d_model, cfg.d_ff

    # one layer's MLP at decode: up and gate (d -> f), down (f -> d), M = slots
    shapes = [(d, f), (d, f), (f, d)]
    sm = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
          "err": 0.0}
    for m, n in shapes:
        x, U, s, V = spectral_inputs(torch, SLOTS, m, n, k, dt, gen)
        sm["ms"] += time_cold(torch, lambda: spectral_matmul(x, U, s, V))
        sm["plain_ms"] += time_cold(torch, lambda: spectral_matmul_ref(x, U, s, V))
        fac = {"U": U, "s": s, "V": V}
        sm["library_ms"] += time_cold(torch, lambda: spectral_apply(fac, x))
        sm["bytes"] += 2 * (SLOTS * m + m * k + n * k + SLOTS * n) + 4 * k
        sm["flops"] += 2 * SLOTS * k * (m + n)
        add_err(sm, spectral_matmul(x, U, s, V), spectral_matmul_ref(x, U, s, V))

    # one layer's decode attention: all slots mid-trace (prompt + half the
    # generation cached), pools at the engine's geometry
    lens = [r.prompt_len + r.max_new_tokens // 2 for r in trace[:SLOTS]]
    kvh, rep, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    q, kp, vp, bt, sl = paged_inputs(torch, lens, PAGES_PER_SEQ, kvh, rep, hd, dt, gen,
                                     null_slot=False)
    pd = {"ms": time_cold(torch, lambda: paged_gqa_decode(q, kp, vp, bt, sl)),
          "plain_ms": time_cold(torch, lambda: paged_gqa_decode_ref(q, kp, vp, bt, sl))}
    # library yardstick: SDPA over the pre-gathered pages (gather not timed)
    b, h = len(lens), cfg.n_heads
    S = PAGES_PER_SEQ * PAGE
    ck = paged_gather(kp, bt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    cv = paged_gather(vp, bt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    qh = q.reshape(b, h, 1, hd)
    mask = (torch.arange(S, device="cuda")[None, :] <= sl[:, None].long())[:, None, None, :]
    pd["library_ms"] = time_cold(
        torch, lambda: F.scaled_dot_product_attention(qh, ck, cv, attn_mask=mask))
    live = sum(n + 1 for n in lens)
    pd["bytes"] = (2 * live * kvh * hd * 2 + 2 * q.numel() * 2
                   + bt.numel() * 4 + sl.numel() * 4)
    pd["flops"] = 4 * h * hd * live
    add_err(pd, paged_gqa_decode(q, kp, vp, bt, sl), paged_gqa_decode_ref(q, kp, vp, bt, sl))

    return [
        kernel_entry("spectral_matmul", "src/repro_torch/csrc/spectral_matmul.cu",
                     "src/repro/kernels/spectral_matmul.py:57", sm, "bfloat16",
                     f"one decode layer's MLP: 2x({SLOTS},{d})->{f} + ({SLOTS},{f})->{d}, "
                     f"rank {k}, bf16", launches, errs),
        kernel_entry("paged_gqa_decode", "src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:110", pd, "float32",
                     f"one decode layer: b={b} kvh={kvh} rep={rep} hd={hd} page={PAGE} "
                     f"lens={lens}, bf16 pools, fp32 math", launches, errs),
    ]


def phase_profile(torch, cfg, engine, prompt_len=96):
    """Device time by kernel over a decode-heavy stretch of serving (four
    ``prompt_len``-token prompts, 32 new tokens each, all slots
    decoding)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(SEED + 2)

    def trace(base):
        return [Request(rid=base + i, prompt=rng.integers(0, cfg.vocab, size=(prompt_len,))
                        .astype(np.int32), max_new_tokens=32) for i in range(SLOTS)]

    engine.run(trace(100))                       # warm
    steps0 = engine.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.run(trace(200))
        torch.cuda.synchronize()
        wall = time.time() - t0
    steps = engine.decode_steps - steps0
    rows = device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] {cfg.name}, {SLOTS} requests x ({prompt_len} prompt + 32 new): wall "
          f"{wall * 1e3:.1f} ms, "
          f"{steps} decode steps, device busy {busy_ms:.1f} ms "
          f"({100.0 * busy_ms / (wall * 1e3):.1f}% of wall)")
    for ms, count, key in rows[:15]:
        print(f"[profile] {ms:10.3f} ms {count:7d}x  {key[:160]}")
    return {"wall_ms": wall * 1e3, "decode_steps": steps, "device_busy_ms": busy_ms}


def flash_inputs(torch, b, s, g, r, d, dtype, gen):
    """q and dout (b, s, g, r, d), k and v (b, s, g, d): unit normals,
    so scores have unit scale and outputs are O(1) averages of v."""
    q, do = (torch.randn((b, s, g, r, d), generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn((b, s, g, d), generator=gen, device="cuda") for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


def phase_train_kernels(torch, cfg):
    """The training path's kernels against their plain versions on the
    card, bf16 and fp32: flash forward (out, m, l) and backward (dq, dk,
    dv) at FLASH_CHECKS, and the spectral autograd Function's (y, dx, dU,
    ds, dV) against autograd through the plain version at M = b * s on
    both MLP shapes (fp32 factors, the legacy masters)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.kernels.testing import compare_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {}

    def check(name, label, got, ref, dtype):
        note(errs, name, compare_kernel(lambda: got, lambda: ref, (), dtype=dtype, label=label))

    M, k = TRAIN_BATCH * TRAIN_SEQ, cfg.sct.rank
    for dtype in (torch.bfloat16, torch.float32):
        for case in FLASH_CHECKS:
            q, kk, v, do = flash_inputs(torch, *case, dtype, gen)
            got, ref = flash_attention_fwd(q, kk, v), flash_fwd_ref(q, kk, v)
            # m and l are fp32 but come from the inputs' dtype: its rung
            for i, what in enumerate(("out", "m", "l")):
                check("flash_attention_fwd", f"flash_attention_fwd {what} {case} {dtype}",
                      got[i], ref[i], dtype)
            args = (q, kk, v, *ref, do)
            got, ref = flash_attention_bwd(*args), flash_bwd_ref(*args)
            for i, what in enumerate(("dq", "dk", "dv")):
                check("flash_attention_bwd", f"flash_attention_bwd {what} {case} {dtype}",
                      got[i], ref[i], dtype)
            del q, kk, v, do, got, ref, args
        for m, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            x, U, s, V = spectral_inputs(torch, M, m, n, k, torch.float32, gen)
            x = x.to(dtype)
            dy = torch.randn((M, n), generator=gen, device="cuda").to(dtype)

            def run(fn):
                leaves = [t.detach().clone().requires_grad_() for t in (x, U, s, V)]
                y = fn(*leaves)
                y.backward(dy)
                return [y.detach()] + [t.grad for t in leaves]

            # only y comes out of the kernel; the gradients are plain GEMMs,
            # checked but kept out of the kernel's error figure
            for what, g, r in zip(("y", "dx", "dU", "ds", "dV"), run(spectral_matmul),
                                  run(spectral_matmul_ref)):
                if g.dtype != r.dtype:
                    raise AssertionError(f"spectral autograd {what}: {g.dtype} vs {r.dtype}")
                check("spectral_matmul" if what == "y" else "spectral_autograd",
                      f"spectral autograd {what} {M}x{m}->{n} {dtype}", g, r, dtype)
        print(f"[kernels] {dtype}: flash_attention_fwd (out, m, l) and flash_attention_bwd "
              f"(dq, dk, dv) match at (b, s, g, r, d) in {FLASH_CHECKS}; spectral_matmul "
              f"autograd (y, dx, dU, ds, dV; fp32 factors) matches at M={M}, both MLP shapes")
    q, kk, v, _ = flash_inputs(torch, 1, 64, 1, 1, 80, torch.bfloat16, gen)
    try:
        flash_attention_fwd(q, kk, v)
    except ValueError as e:
        print(f"[kernels] flash_attention_fwd refuses head dim 80: {e}")
    else:
        raise AssertionError("flash_attention_fwd accepted head dim 80")
    torch.cuda.synchronize()
    return errs


def phase_training(torch, device):
    """Full-width smollm2-1.7b through Trainer.step(); returns the train
    record. Launch counts are zeroed just before each step and read just
    after it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import ModelSpec, RunSpec, Trainer, TrainSpec
    from repro_torch.checkpoint.store import flatten, unflatten
    from repro_torch.core.tree import max_orthogonality_error
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.model import param_count, train_loss

    spec = RunSpec(model=ModelSpec(TRAIN_ARCH),
                   train=TrainSpec(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                   lr=1e-3, seed=SEED))
    t0 = time.time()
    trainer = Trainer(spec, device=device)
    cfg = trainer.cfg
    n_params = param_count(trainer.params)
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {n_params} parameters, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, rank {cfg.sct.rank}, retraction "
          f"{cfg.sct.retraction}, precision {spec.precision.mode} ({cfg.dtype} compute over "
          f"fp32 masters), remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}; init "
          f"{time.time() - t0:.1f} s")
    # data set-up outside the timed steps: the trainer's own stream
    batches = [trainer.make_batch(i) for i in range(TRAIN_STEPS + 1)]
    # per step: the flash forward runs twice per layer (forward and remat
    # recompute), its backward once; the three spectral MLP projections
    # run forward and recompute; the spectral backward is plain GEMMs
    expect = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
              "spectral_matmul": 6 * cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, orthos = [], [], []
    totals = {name: 0 for name in expect}
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t1 = time.perf_counter()
        metrics = trainer.step(batches[i])
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launches = {name: LAUNCHES.get(name, 0) for name in expect}
        ortho = float(max_orthogonality_error(trainer.params))
        print(f"[train] step {i + 1}: loss {loss:.6f}, step {ms:.1f} ms, max orthogonality "
              f"error {ortho:.3e}, launches {launches}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i + 1}: loss {loss}")
        if not ortho <= ORTHO_LIMIT:
            raise AssertionError(f"step {i + 1}: orthogonality error {ortho} > {ORTHO_LIMIT}")
        if launches != expect:
            raise AssertionError(f"step {i + 1}: launches {launches}, expected {expect}")
        losses.append(loss)
        step_ms.append(ms)
        orthos.append(ortho)
        for name in expect:
            totals[name] += launches[name]
    peak_mem = torch.cuda.max_memory_allocated()
    warm = sorted(step_ms[2:])
    warm_ms = (warm[len(warm) // 2 - 1] + warm[len(warm) // 2]) / 2
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (warm_ms / 1e3)
    print(f"[train] median warm step (steps 3-{TRAIN_STEPS}) {warm_ms:.1f} ms, "
          f"{tokens_per_s:.1f} tokens/s; max_memory_allocated {peak_mem}; launches over "
          f"{TRAIN_STEPS} steps {totals}")

    # every gradient leaf is finite and non-zero (one more forward and
    # backward on the trained weights, after the counted steps)
    leaves = {path: t.detach().requires_grad_() for path, t in flatten(trainer.params).items()}
    loss, _ = train_loss(unflatten(leaves), batches[0], cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for path, g in zip(leaves, grads):
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
            raise AssertionError(f"gradient of {path}: finite {bool(torch.isfinite(g).all())}, "
                                 f"max |g| {float(g.abs().max())}")
    print(f"[train] all {len(grads)} parameter leaves get finite, non-zero gradients")
    del leaves, grads, loss

    # one warm step under the profiler: device time by kernel, busy share
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        trainer.step(batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = time.time() - t1
    rows = device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] one warm training step ({cfg.name}, {TRAIN_BATCH}x{TRAIN_SEQ}): wall "
          f"{wall * 1e3:.1f} ms under the profiler, device busy {busy_ms:.1f} ms "
          f"({100.0 * busy_ms / (wall * 1e3):.1f}% of wall)")
    for ms, count, key in rows[:20]:
        print(f"[profile] {ms:10.3f} ms {count:7d}x  {key[:160]}")
    return {
        "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms, "ortho": orthos,
        "warm_step_ms": warm_ms, "tokens_per_s": tokens_per_s,
        "max_memory_allocated": peak_mem, "launches": totals, "launches_per_step": expect,
        "profile": {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                    "top": [{"ms": ms, "launches": c, "kernel": key[:120]}
                            for ms, c, key in rows[:20]]},
    }


def phase_resume(torch, device):
    """Reduced smollm2 on the card: an uninterrupted 6-step run against a
    run saved at step 3 and resumed, through Trainer.resume and fit."""
    import tempfile
    from repro_torch.api import CheckpointSpec, ModelSpec, RunSpec, Trainer, TrainSpec
    from repro_torch.checkpoint.store import flatten

    with tempfile.TemporaryDirectory() as tmp:
        def spec(name):
            return RunSpec(model=ModelSpec(TRAIN_ARCH, reduced=True),
                           train=TrainSpec(steps=6, batch=2, seq=64, lr=1e-3, seed=SEED),
                           checkpoint=CheckpointSpec(directory=f"{tmp}/{name}", every=3))

        straight = Trainer(spec("a"), device=device)
        losses = [float(straight.step()["loss"]) for _ in range(6)]
        first = Trainer(spec("b"), device=device)
        for _ in range(3):
            first.step()
        first.save()
        resumed = Trainer.resume(f"{tmp}/b", device=device)
        tail = [float(resumed.step()["loss"]) for _ in range(3)]
        final = Trainer.resume(f"{tmp}/b", device=device).fit()
        same_params = all(torch.equal(t, flatten(straight.params)[key])
                          for key, t in flatten(final["params"]).items())
    print(f"[resume] reduced {TRAIN_ARCH}: losses {losses}; resumed from step 3: {tail}; "
          f"fit() from step 3 ends on the uninterrupted run's parameters: {same_params}")
    if tail != losses[3:] or not same_params:
        raise AssertionError("resume on the card is not bit-identical")
    return {"losses": losses, "resumed": tail, "bit_identical": True}


def phase_train_timing(torch, cfg, launches, errs):
    """Kernel, plain and library times at the training shapes, in device
    time only."""
    import torch.nn.functional as F
    from repro_torch.core.spectral import spectral_apply
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.ref import spectral_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dt = torch.bfloat16
    b, s, h, g, d = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    r = h // g
    q, k, v, do = flash_inputs(torch, b, s, g, r, d, dt, gen)
    out, m, l = flash_attention_fwd(q, k, v)
    ref = flash_fwd_ref(q, k, v)
    fwd = {"ms": time_cold(torch, lambda: flash_attention_fwd(q, k, v)),
           "plain_ms": time_cold(torch, lambda: flash_fwd_ref(q, k, v))}
    add_err(fwd, out, ref[0])
    bwd = {"ms": time_cold(torch, lambda: flash_attention_bwd(q, k, v, out, m, l, do)),
           "plain_ms": time_cold(torch, lambda: flash_bwd_ref(q, k, v, out, m, l, do))}
    for a, c in zip(flash_attention_bwd(q, k, v, out, m, l, do),
                    flash_bwd_ref(q, k, v, out, m, l, do)):
        add_err(bwd, a, c)
    del ref

    # library yardstick: SDPA in its (b, h, s, d) layout, causal; the
    # backward alone is autograd.grad through a recorded SDPA forward
    def heads(t):
        return t.reshape(b, s, h, d).transpose(1, 2).contiguous()

    qh = heads(q)
    kh, vh = (heads(t[:, :, :, None].expand(b, s, g, r, d)) for t in (k, v))
    fwd["library_ms"] = time_cold(
        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
    oh = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    doh = heads(do)
    bwd["library_ms"] = time_cold(
        torch, lambda: torch.autograd.grad(oh, (qg, kg, vg), doh, retain_graph=True))
    bwd["library_fwd_bwd_ms"] = time_cold(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), doh))
    act = b * s * h * d * 2                                # one (b, s, h, d) bf16 tensor
    kv = b * s * g * d * 2
    stats = b * s * h * 4                                  # one (b, s, g, r) fp32 tensor
    fwd["flops"] = 2 * 2 * b * h * s * s * d / 2           # QK^T and PV, causal half
    fwd["bytes"] = 2 * act + 2 * kv + 2 * stats            # q, k, v in; out, m, l out
    bwd["flops"] = 2.5 * fwd["flops"]                      # S, dP, dV, dQ, dK
    bwd["bytes"] = 3 * act + 2 * kv + 2 * stats + act + 2 * kv   # q k v out do m l in; dq dk dv
    del qh, kh, vh, qg, kg, vg, oh, doh, q, k, v, do, out, m, l

    # one MLP up projection in training: (b * s, d_model) -> d_ff
    M, mm, n, kk = b * s, cfg.d_model, cfg.d_ff, cfg.sct.rank
    x, U, sv, V = spectral_inputs(torch, M, mm, n, kk, dt, gen)
    fac = {"U": U, "s": sv, "V": V}
    sm = {"ms": time_cold(torch, lambda: spectral_matmul(x, U, sv, V)),
          "plain_ms": time_cold(torch, lambda: spectral_matmul_ref(x, U, sv, V)),
          "library_ms": time_cold(torch, lambda: spectral_apply(fac, x)),
          "bytes": 2 * (M * mm + mm * kk + n * kk + M * n) + 4 * kk,
          "flops": 2 * M * kk * (mm + n)}
    add_err(sm, spectral_matmul(x, U, sv, V), spectral_matmul_ref(x, U, sv, V))
    shape = (f"one smollm2 layer in training: b={b} s={s} heads={h} kv_heads={g} d={d}, "
             f"causal, bf16")
    return [
        kernel_entry("flash_attention_fwd", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:64", fwd, "bfloat16", shape,
                     launches, errs),
        kernel_entry("flash_attention_bwd", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/nn/attention.py:136", bwd, "bfloat16",
                     shape + "; library: SDPA backward alone", launches, errs),
    ], kernel_entry("spectral_matmul", "src/repro_torch/csrc/spectral_matmul.cu",
                    "src/repro/kernels/spectral_matmul.py:57", sm, "bfloat16",
                    f"one up projection in training: ({M},{mm})->{n}, rank {kk}, bf16",
                    {}, {})


def q8_inputs(torch, M, m, n, k, profile, dtype, gen):
    """x and {"q8", "scale"} factors: random codes, per-column scales of
    a ``scale_profile`` kind (v's reversed, so the fused gain spans
    both), s uniform. Factor entries come out O(1/sqrt(m))."""
    from repro_torch.kernels.testing import scale_profile

    x = torch.randn((M, m), generator=gen, device="cuda").to(dtype)
    codes = [torch.randint(-127, 128, (r, k), generator=gen, device="cuda").to(torch.int8)
             for r in (m, n)]
    us = scale_profile(profile, k, device="cuda") / math.sqrt(m) / 127.0
    vs = scale_profile(profile, k, device="cuda").flip(0) / math.sqrt(k) / 127.0
    s = torch.rand((k,), generator=gen, device="cuda")
    return x, {"q8": codes[0], "scale": us}, s, {"q8": codes[1], "scale": vs}


def q8_plain(x, U, s, V):
    """The int8 kernel's plain version through the wrapper's own gain."""
    from repro_torch.kernels.ref import spectral_matmul_q8_ref

    return spectral_matmul_q8_ref(x, U["q8"], U["scale"] * s * V["scale"], V["q8"])


def cold_inputs(torch, seq_lens, n_pages, kvh, rep, hd, dtype, gen, *, null_slot, p_cold):
    """paged_inputs plus int8 shadow pools quantized from noise that is
    independent of the pools (a read of the wrong tier misses by O(1))
    and cold flags drawn with probability p_cold."""
    from repro_torch.serving.quantize import quantize_kv_pages

    q, k_pool, v_pool, bt, sl = paged_inputs(torch, seq_lens, n_pages, kvh, rep, hd, dtype,
                                             gen, null_slot=null_slot)
    shadows = [quantize_kv_pages(torch.randn(tuple(k_pool.shape), generator=gen,
                                             device="cuda"), token_axis=1) for _ in range(2)]
    cold = (torch.rand((k_pool.shape[0],), generator=gen, device="cuda") < p_cold).int()
    return (q, k_pool, v_pool, shadows[0]["q8"], shadows[0]["scale"], shadows[1]["q8"],
            shadows[1]["scale"], bt, sl, cold)


def phase_int8_kernels(torch, cfg):
    """The int8 kernels against their plain versions on the card."""
    from repro_torch.kernels.ops import spectral_matmul_q8
    from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold
    from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref
    from repro_torch.kernels.testing import SCALE_PROFILES, compare_kernel, ragged_seq_lens

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    k = cfg.sct.rank
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for m, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            for profile in SCALE_PROFILES:
                for M in Q8_ROWS:
                    args = q8_inputs(torch, M, m, n, k, profile, dtype, gen)
                    note(errs, "spectral_matmul_q8", compare_kernel(
                        spectral_matmul_q8, q8_plain, args,
                        label=f"spectral_matmul_q8 {M}x{m}->{n} {profile} {dtype}"))
            x, U, sv, V = q8_inputs(torch, 37, m, n, k, "extreme", dtype, gen)
            full = spectral_matmul_q8(x, U, sv, V)
            for i in range(37):
                if not torch.equal(spectral_matmul_q8(x[i:i + 1], U, sv, V)[0], full[i]):
                    raise AssertionError(f"spectral_matmul_q8 {m}->{n} {dtype}: row {i} of "
                                         "M=37 differs from the row alone")
        n_pages = 12
        lens = ragged_seq_lens(8, PAGE * n_pages - 1, PAGE, seed=SEED).tolist()
        for p_cold in (0.0, 0.5, 1.0):
            args = cold_inputs(torch, lens, n_pages, cfg.n_kv_heads,
                               cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, dtype, gen,
                               null_slot=True, p_cold=p_cold)
            for part, what in ((slice(1, None), "live slots"), (slice(0, 1), "null slot")):
                note(errs, "paged_gqa_decode_cold", compare_kernel(
                    lambda *a: paged_gqa_decode_cold(*a)[part],
                    lambda *a: paged_gqa_decode_cold_ref(*a)[part], args,
                    label=f"paged_gqa_decode_cold p_cold={p_cold} {dtype} {what}"))
            if p_cold == 0.0:
                q, kp, vp, _, _, _, _, bt, sl, _ = args
                if not torch.equal(paged_gqa_decode_cold(*args),
                                   paged_gqa_decode(q, kp, vp, bt, sl)):
                    raise AssertionError(f"paged_gqa_decode_cold {dtype}: with no page "
                                         "flagged it differs from paged_gqa_decode")
        print(f"[kernels] {dtype}: spectral_matmul_q8 (M in {list(Q8_ROWS)}, both MLP "
              f"shapes, scale profiles {list(SCALE_PROFILES)}) matches and is batch "
              f"invariant (M=37 rows == M=1); paged_gqa_decode_cold (p_cold 0/0.5/1, "
              f"ragged lens {lens}, null slot) matches, bit-identical to paged_gqa_decode "
              f"with no page flagged")
    torch.cuda.synchronize()
    return errs


def run_measured(torch, engine, trace):
    """Serve ``trace`` with the launch counts zeroed just before and read
    just after; return (tokens, launches, this run's own numbers: the
    engine's counters less their values before it, and the run's ITL)."""
    import numpy as np
    from repro_torch.kernels.build import LAUNCHES

    before = engine.stats()
    gaps_before = len(engine.step_times)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    out = engine.run(trace)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    after = engine.stats()
    st = {key: after[key] - before[key] for key in after
          if key in ("requests", "prefill_tokens", "prefill_chunks", "generated_tokens",
                     "decode_steps", "wall_s", "stream_evictions", "stream_demotions",
                     "cold_page_bytes")}
    st["tokens_per_s"] = (st["prefill_tokens"] + st["generated_tokens"]) / st["wall_s"]
    gaps = np.asarray(list(engine.step_times)[gaps_before:])
    st["itl_p50_s"] = float(np.percentile(gaps, 50))
    st["itl_p99_s"] = float(np.percentile(gaps, 99))
    st["itl_gaps"] = len(gaps)
    return out, launches, st


def require_launches(launches, expect):
    got = {name: launches.get(name, 0) for name in expect}
    if got != expect:
        raise AssertionError(f"launches {got}, expected {expect}")


def phase_int8_serving(torch, cfg, device, masters, bf16_weight_bytes):
    """Full-width int8 serving on phase 3's trace and geometry."""
    import numpy as np
    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.models.model import serving_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig
    from repro_torch.serving.quantize import dequantize_tree

    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=NUM_PAGES, max_slots=SLOTS,
                            max_pages_per_seq=PAGES_PER_SEQ)
    engine = ServingEngine(cfg, masters, pcfg, device=device, prefill_token_budget=64,
                           quantize="int8")
    wb = engine.weight_bytes
    print(f"[int8] weight_bytes {wb} int8 against {bf16_weight_bytes} bf16 serving bytes "
          f"({bf16_weight_bytes / wb:.3f}x smaller; fp32 masters {engine.weight_bytes_fp})")
    engine.run(make_trace(cfg.vocab, SEED + 3, rid0=len(TRACE)))       # warm-up
    trace = make_trace(cfg.vocab, SEED)
    torch.cuda.reset_peak_memory_stats()
    out, launches, st = run_measured(torch, engine, trace)
    peak_mem = torch.cuda.max_memory_allocated()
    engine.sched.check_invariants()
    steps = int(st["decode_steps"]) + int(st["prefill_chunks"])
    require_launches(launches, {"spectral_matmul_q8": 3 * cfg.n_layers * steps,
                                "spectral_matmul": 0})
    print(f"[int8] {int(st['requests'])} requests, {int(st['prefill_tokens'])} prefill + "
          f"{int(st['generated_tokens'])} generated tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']:.1f} tok/s), {int(st['decode_steps'])} decode steps + "
          f"{int(st['prefill_chunks'])} prefill chunks, ITL p50 "
          f"{st['itl_p50_s'] * 1e3:.3f} ms p99 {st['itl_p99_s'] * 1e3:.3f} ms, launches "
          f"{launches}")
    for r in trace:
        got = out[r.rid]
        if engine.last_statuses.get(r.rid) != "finished" or len(got) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: status {engine.last_statuses.get(r.rid)}")
    gap = check_oracles(engine, trace, out, trace, "int8")
    dequant = dequantize_tree(engine.params)
    bf16 = serving_params(masters, cfg, device)
    agree = {"dequantized": 0, "unquantized": 0}
    total = 0
    for r in trace:
        got = out[r.rid]
        for name, tree in (("dequantized", dequant), ("unquantized", bf16)):
            other = static_greedy_reference(cfg, tree, r.prompt, r.max_new_tokens,
                                            pcfg.max_seq, device=device)
            agree[name] += int(np.sum(other == got))
        total += len(got)
    del dequant, bf16
    print(f"[int8] diagnostic, free-running static greedy path: {agree['dequantized']}/"
          f"{total} tokens identical over the dequantized tree (bf16 kernel), "
          f"{agree['unquantized']}/{total} over the unquantized weights")
    record = {"weight_bytes": wb, "bf16_weight_bytes": bf16_weight_bytes,
              "weight_bytes_fp32": engine.weight_bytes_fp,
              "requests": int(st["requests"]), "decode_steps": int(st["decode_steps"]),
              "prefill_chunks": int(st["prefill_chunks"]),
              "prefill_tokens": int(st["prefill_tokens"]),
              "generated_tokens": int(st["generated_tokens"]), "wall_s": st["wall_s"],
              "tokens_per_s": st["tokens_per_s"], "itl_gaps": st["itl_gaps"],
              "itl_p50_ms": st["itl_p50_s"] * 1e3, "itl_p99_ms": st["itl_p99_s"] * 1e3,
              "max_memory_allocated": peak_mem, "launches": launches,
              "identical_to_replay_alone": len(trace), "max_static_gap": gap,
              "agree_dequantized": agree["dequantized"],
              "agree_unquantized": agree["unquantized"], "tokens": total}
    return engine, record


def check_oracles(engine, alone, out, to_static, tag):
    """``launch/serve.py:check_oracles`` (the CLI's ``--verify`` gate in
    bf16): every request of ``alone`` equals its replay alone through a
    fresh engine of the same configuration (exact); the requests of
    ``to_static`` stay within the tolerance ladder of the static path,
    teacher-forced over the engine's tokens. Returns the largest static
    gap (<= 1 passes) and prints how many tokens were exactly the static
    path's choice."""
    from repro_torch.launch.serve import check_oracles as gate

    try:
        rep = gate(engine, alone, out, to_static)
    except AssertionError as e:
        raise AssertionError(f"{tag} {e}") from None
    print(f"[{tag}] {rep['alone']} requests == the request served alone (bit for bit); "
          f"{rep['static']} requests teacher-forced through the static path: every token "
          f"within the ladder of its best logit (largest gap {rep['max_gap']:.3f} of the "
          f"allowance), {rep['exact']}/{rep['tokens']} exactly its choice")
    return rep["max_gap"]


def stream_trace(vocab, seed):
    import numpy as np
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=(plen,)).astype(np.int32),
                    max_new_tokens=gen, arrival=arrival)
            for i, (plen, gen, arrival) in enumerate(STREAM_TRACE)]


def phase_streaming(torch, cfg, device, masters):
    """Full-width streaming with int8 weights and the int8 cold tier; the
    same trace twice on one engine."""
    import numpy as np
    from repro_torch.kernels.paged_decode import paged_gqa_decode_cold
    from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref
    from repro_torch.kernels.testing import assert_kernel_matches
    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig
    from repro_torch.serving.streaming import StreamingConfig, identity_horizon, resident_cap

    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=STREAM_PAGES, max_slots=STREAM_SLOTS,
                            max_pages_per_seq=STREAM_PAGES_PER_SEQ)
    scfg = StreamingConfig(sink_pages=SINK, window_pages=WINDOW, cold_kv="int8")
    engine = ServingEngine(cfg, masters, pcfg, device=device, prefill_token_budget=64,
                           quantize="int8", streaming=scfg)
    horizon, cap = identity_horizon(scfg, pcfg), resident_cap(scfg)
    trace = stream_trace(cfg.vocab, SEED + 7)

    # per-sequence resident pages after every decode step, and one layer's
    # pools with their flags at step SNAPSHOT_STEP of the first run
    peak = [0]
    snapshot = {}
    decode_once = engine._decode_once

    def observed_decode():
        decode_once()
        peak[0] = max([peak[0]] + [len(sq.pages) for sq in engine.sched.active.values()])
        if not snapshot and engine.decode_steps == SNAPSHOT_STEP:
            bt, sl = engine.sched.decode_view()
            snapshot.update({name: leaf[0].clone()
                             for name, leaf in engine.state["cache"].items()})
            snapshot.update(bt=torch.as_tensor(bt).to(device), sl=torch.as_tensor(sl).to(device),
                            cold=engine._cold_flags().clone())

    engine._decode_once = observed_decode
    runs = []
    for _ in range(2):
        out, launches, st = run_measured(torch, engine, trace)
        engine.sched.check_invariants()
        if engine.sched.pool.allocated_count != 0:
            raise AssertionError("pages still allocated after the streaming trace")
        runs.append((out, launches, st))
        print(f"[stream] {int(st['requests'])} requests, {int(st['prefill_tokens'])} "
              f"prefill + {int(st['generated_tokens'])} generated tokens in "
              f"{st['wall_s']:.3f} s ({st['tokens_per_s']:.1f} tok/s), "
              f"{int(st['decode_steps'])} decode steps, ITL p50 "
              f"{st['itl_p50_s'] * 1e3:.3f} ms p99 {st['itl_p99_s'] * 1e3:.3f} ms, "
              f"{int(st['stream_evictions'])} evictions, {int(st['stream_demotions'])} "
              f"demotions ({int(st['cold_page_bytes'])} shadow bytes), launches {launches}")
    (out, launches, st), (out2, _, st2) = runs
    ledger = ("stream_evictions", "stream_demotions", "cold_page_bytes", "decode_steps",
              "prefill_chunks", "generated_tokens")
    if any(st[key] != st2[key] for key in ledger):
        raise AssertionError(f"the second run's ledger differs: "
                             f"{ {k: (st[k], st2[k]) for k in ledger} }")
    for r in trace:
        if not np.array_equal(out[r.rid], out2[r.rid]):
            raise AssertionError(f"stream request {r.rid}: the second run's tokens differ")
        if len(out[r.rid]) != r.max_new_tokens:
            raise AssertionError(f"stream request {r.rid}: {len(out[r.rid])} tokens")
    if not (st["stream_evictions"] > 0 and st["stream_demotions"] > 0):
        raise AssertionError(f"the streaming run neither evicted nor demoted: {st}")
    if peak[0] > cap:
        raise AssertionError(f"a sequence held {peak[0]} pages > the resident cap {cap}")
    for run_launches, run_st in ((launches, st), (runs[1][1], st2)):
        steps = int(run_st["decode_steps"])
        require_launches(run_launches, {
            "paged_gqa_decode_cold": cfg.n_layers * steps, "paged_gqa_decode": 0,
            "spectral_matmul_q8": 3 * cfg.n_layers * (steps + int(run_st["prefill_chunks"])),
            "spectral_matmul": 0})
    print(f"[stream] deterministic across two runs (tokens and ledger); peak resident "
          f"pages per sequence {peak[0]} <= cap {cap}")
    engine._decode_once = decode_once
    short = [r for r in trace if r.prompt_len + r.max_new_tokens <= horizon]
    gap = check_oracles(engine, trace[:1] + short, out, short, "stream")
    agree = total = 0
    for r in short:
        ref = static_greedy_reference(cfg, engine.params, r.prompt, r.max_new_tokens,
                                      pcfg.max_seq, device=device)
        agree += int(np.sum(ref == out[r.rid]))
        total += len(ref)
    print(f"[stream] diagnostic: {agree}/{total} tokens of the {len(short)} requests within "
          f"the {horizon}-token horizon identical to the free-running static greedy path")

    # the snapshot: this layer's real pools, its cold flags, a fresh query
    n_cold = int(snapshot["cold"][snapshot["bt"].long()].ne(0).sum())
    if n_cold == 0:
        raise AssertionError("the mid-session snapshot has no cold page in any block table")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    q = torch.randn((STREAM_SLOTS, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.head_dim), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, snapshot["k"], snapshot["v"], snapshot["k_q8"], snapshot["k_scale"],
            snapshot["v_q8"], snapshot["v_scale"], snapshot["bt"], snapshot["sl"],
            snapshot["cold"])
    snap_err = assert_kernel_matches(paged_gqa_decode_cold, paged_gqa_decode_cold_ref, args,
                                     label="paged_gqa_decode_cold on the session snapshot")
    print(f"[stream] step-{SNAPSHOT_STEP} snapshot of layer 0 (lens "
          f"{snapshot['sl'].tolist()}, {n_cold} cold pages mapped): cold kernel == plain "
          f"version (max abs err {snap_err:.3e})")
    st2 = runs[1][2]
    record = {"requests": int(st2["requests"]), "decode_steps": int(st2["decode_steps"]),
              "prefill_chunks": int(st2["prefill_chunks"]),
              "prefill_tokens": int(st2["prefill_tokens"]),
              "generated_tokens": int(st2["generated_tokens"]), "wall_s": st2["wall_s"],
              "tokens_per_s": st2["tokens_per_s"], "itl_gaps": st2["itl_gaps"],
              "itl_p50_ms": st2["itl_p50_s"] * 1e3, "itl_p99_ms": st2["itl_p99_s"] * 1e3,
              "first_run_itl_p50_ms": st["itl_p50_s"] * 1e3,
              "first_run_itl_p99_ms": st["itl_p99_s"] * 1e3,
              "stream_evictions": int(st["stream_evictions"]),
              "stream_demotions": int(st["stream_demotions"]),
              "cold_page_bytes": int(st["cold_page_bytes"]), "peak_pages_per_seq": peak[0],
              "resident_cap": cap, "horizon": horizon, "short_requests": len(short),
              "identical_to_replay_alone": 1 + len(short), "max_static_gap": gap,
              "short_agree_static": agree, "short_tokens": total,
              "launches": launches, "snapshot_cold_pages": n_cold,
              "snapshot_max_abs_err": snap_err}
    return engine, record


def phase_int8_timing(torch, cfg, q8_launches, cold_launches, errs):
    """Int8 kernel, plain and library times at the decode shapes (and the
    int8 matmul at a 64-token prefill chunk), in device time only."""
    import torch.nn.functional as F
    from repro_torch.core.spectral import spectral_apply
    from repro_torch.kernels.ops import spectral_matmul_q8
    from repro_torch.kernels.paged_decode import paged_gqa_decode_cold
    from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref
    from repro_torch.serving.paged_cache import paged_gather
    from repro_torch.serving.quantize import dequantize_int8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dt = torch.bfloat16
    k, d, f = cfg.sct.rank, cfg.d_model, cfg.d_ff
    entries = []
    for M, what in ((SLOTS, "one decode layer's MLP"),
                    (Q8_PREFILL_M, "one 64-token prefill chunk's MLP")):
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
             "err": 0.0}
        for m, n in ((d, f), (d, f), (f, d)):
            x, U, s, V = q8_inputs(torch, M, m, n, k, "unit", dt, gen)
            t["ms"] += time_cold(torch, lambda: spectral_matmul_q8(x, U, s, V))
            t["plain_ms"] += time_cold(torch, lambda: q8_plain(x, U, s, V))
            # library yardstick: the three-GEMM chain over pre-dequantized
            # bf16 factors (dequantization not timed)
            fac = {"U": dequantize_int8(U, dt), "s": s, "V": dequantize_int8(V, dt)}
            t["library_ms"] += time_cold(torch, lambda: spectral_apply(fac, x))
            t["bytes"] += 2 * (M * m + M * n) + (m + n) * k + 3 * 4 * k
            t["flops"] += 2 * M * k * (m + n)
            add_err(t, spectral_matmul_q8(x, U, s, V), q8_plain(x, U, s, V))
        entries.append((M, what, t))

    # one layer's cold decode in the streaming cell's geometry: every slot
    # holds its six resident pages (95 tokens), the page after the sink cold
    kvh, rep, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    lens = [SINK * PAGE + WINDOW * PAGE + PAGE - 1] * STREAM_SLOTS
    args = cold_inputs(torch, lens, STREAM_PAGES_PER_SEQ, kvh, rep, hd, dt, gen,
                       null_slot=False, p_cold=0.0)
    q, kp, vp, kq, ks, vq, vs, bt, sl, cold = args
    cold[bt[:, SINK].long()] = 1
    b, h = len(lens), cfg.n_heads
    cd = {"ms": time_cold(torch, lambda: paged_gqa_decode_cold(*args)),
          "plain_ms": time_cold(torch, lambda: paged_gqa_decode_cold_ref(*args))}
    # library yardstick: SDPA over pre-gathered, pre-dequantized pages
    sel = (cold != 0)[:, None, None, None]
    kd = torch.where(sel, kq.float() * ks[:, None], kp.float()).to(dt)
    vd = torch.where(sel, vq.float() * vs[:, None], vp.float()).to(dt)
    S = STREAM_PAGES_PER_SEQ * PAGE
    ck = paged_gather(kd, bt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    cv = paged_gather(vd, bt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    qh = q.reshape(b, h, 1, hd)
    mask = (torch.arange(S, device="cuda")[None, :] <= sl[:, None].long())[:, None, None, :]
    cd["library_ms"] = time_cold(
        torch, lambda: F.scaled_dot_product_attention(qh, ck, cv, attn_mask=mask))
    live = sum(n + 1 for n in lens)
    cold_rows = b * PAGE                       # one cold page a slot
    cold_pages = b
    cd["bytes"] = (2 * (live - cold_rows) * kvh * hd * 2 + 2 * cold_rows * kvh * hd
                   + 2 * cold_pages * kvh * hd * 4 + 2 * q.numel() * 2 + bt.numel() * 4
                   + sl.numel() * 4 + 4 * sum(n // PAGE + 1 for n in lens))
    cd["flops"] = 4 * h * hd * live
    add_err(cd, paged_gqa_decode_cold(*args), paged_gqa_decode_cold_ref(*args))

    (m1, what1, t1), (m2, what2, t2) = entries
    q8 = kernel_entry("spectral_matmul_q8", "src/repro_torch/csrc/spectral_matmul_q8.cu",
                      "src/repro/kernels/spectral_matmul_q8.py:65", t1, "bfloat16",
                      f"{what1}: 2x({m1},{d})->{f} + ({m1},{f})->{d}, rank {k}, int8 "
                      f"factors, bf16 activations; library: three-GEMM chain over "
                      f"pre-dequantized bf16 factors", q8_launches, errs)
    q8["at_prefill_chunk"] = {
        "shape": f"{what2}: 2x({m2},{d})->{f} + ({m2},{f})->{d}",
        "ms": t2["ms"], "plain_ms": t2["plain_ms"], "library_ms": t2["library_ms"],
        "max_abs_err": t2["err"], "max_scaled_err": t2["scaled"],
        **bound_of(t2, "bfloat16")}
    entries = [q8, kernel_entry(
        "paged_gqa_decode_cold", "src/repro_torch/csrc/paged_decode.cu",
        "src/repro/kernels/paged_decode.py:205", cd, "float32",
        f"one streaming decode layer: b={b} kvh={kvh} rep={rep} hd={hd} page={PAGE} "
        f"lens={lens}, one cold page a slot, bf16 pools + int8 shadows, fp32 math; "
        f"library: SDPA over pre-gathered, pre-dequantized pages", cold_launches, errs)]
    return entries


def xlstm_spectral_shapes(cfg):
    """(m, n) of xlstm's spectral projections: up, down, ff_up, ff_down."""
    d, di, dff = cfg.d_model, 2 * cfg.d_model, int(4 * cfg.d_model / 3)
    return [(d, 2 * di), (di, d), (d, 2 * dff), (dff, d)]


def phase_xlstm_kernels(torch, cfg):
    """The mLSTM kernel against its plain version on the card over the
    sweep (y, C, n, m at the fp32 rung), and the spectral kernel at
    xlstm's four projection shapes."""
    from repro_torch.kernels.mlstm_chunk import CHUNK, mlstm_chunk
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.kernels.testing import MLSTM_PROFILES, compare_kernel, mlstm_inputs

    errs = {}
    cases = 0
    for dh in MLSTM_DH:
        for B in MLSTM_B:
            for S in MLSTM_S:
                for profile in MLSTM_PROFILES:
                    for with_state in (False, True):
                        q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=SEED + S,
                                                            device="cuda",
                                                            with_state=with_state)
                        y, got = mlstm_chunk(q, k, v, i, f, state)
                        # the plain version cut into the kernel's chunks: the
                        # same function, the same prefix sums
                        yr, ref = mlstm_chunk_ref(q, k, v, i, f, state, chunk=CHUNK,
                                                  ragged=True)
                        for name, g, r in zip(("y", "C", "n", "m"), (y, *got), (yr, *ref)):
                            note(errs, "mlstm_chunk", compare_kernel(
                                lambda: g, lambda: r, (), dtype=torch.float32,
                                label=f"mlstm_chunk {name} B={B} S={S} dh={dh} {profile} "
                                      f"state={with_state}"))
                        cases += 1
    print(f"[kernels] mlstm_chunk: y, C, n, m match the plain version over {cases} cases "
          f"(dh {list(MLSTM_DH)}, B {list(MLSTM_B)}, S {list(MLSTM_S)}, gate profiles "
          f"{list(MLSTM_PROFILES)}, with and without an initial state); max scaled error "
          f"{errs['mlstm_chunk'][1]:.3e}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    shapes = xlstm_spectral_shapes(cfg)
    for dtype in (torch.bfloat16, torch.float32):
        for m, n in shapes:
            for M in (1, SLOTS, MLSTM_PREFILL_S):
                args = spectral_inputs(torch, M, m, n, cfg.sct.rank, dtype, gen)
                note(errs, "spectral_matmul", compare_kernel(
                    spectral_matmul, spectral_matmul_ref, args,
                    label=f"spectral_matmul {M}x{m}->{n} {dtype}"))
    print(f"[kernels] spectral_matmul at xlstm's shapes {shapes} (M 1/{SLOTS}/"
          f"{MLSTM_PREFILL_S}, bf16 and fp32) matches")
    torch.cuda.synchronize()
    return errs


def phase_xlstm_serving(torch, device):
    """xlstm-1.3b at full width through the engine on slice 1's trace and
    geometry; returns (engine, record)."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.core.tree import layer_slice
    from repro_torch.launch.serve import static_logit_gaps
    from repro_torch.models.decode import recurrent_slot_axes
    from repro_torch.models.lm import n_periods
    from repro_torch.models.model import init_decode_state, init_model, param_count, prefill
    from repro_torch.nn import xlstm as xlstm_mod
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    cfg = get_config(XLSTM_ARCH)
    t0 = time.time()
    masters = init_model(cfg, seed=SEED, device=device)
    n_params = param_count(masters)
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=NUM_PAGES, max_slots=SLOTS,
                            max_pages_per_seq=PAGES_PER_SEQ)
    engine = ServingEngine(cfg, masters, pcfg, device=device, prefill_token_budget=64)
    del masters                                 # the engine holds its bf16 copy
    torch.cuda.synchronize()
    wr = engine.params["periods"][f"p{cfg.slstm_offset}"]["slstm"]["wr"]
    if wr.dtype != torch.float32:
        raise AssertionError(f"the sLSTM's wr is served in {wr.dtype}, not fp32")
    state_bytes = engine.recurrent_state_bytes()
    print(f"[xlstm] {cfg.name}: {n_params} parameters, {cfg.n_layers} blocks "
          f"({n_periods(cfg)} periods of {cfg.slstm_every - 1} mLSTM + 1 sLSTM), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads (mLSTM head width "
          f"{2 * cfg.d_model // cfg.n_heads}), vocab {cfg.vocab}, rank {cfg.sct.rank}, "
          f"{cfg.dtype}; weight_bytes {engine.weight_bytes}, recurrent state {state_bytes} "
          f"bytes ({SLOTS} slots); init + load {time.time() - t0:.1f} s")
    engine.run(make_trace(cfg.vocab, SEED + 3, rid0=len(TRACE)))       # warm-up
    before = engine.stats()
    trace = make_trace(cfg.vocab, SEED)
    torch.cuda.reset_peak_memory_stats()
    out, launches, st = run_measured(torch, engine, trace)
    peak_mem = torch.cuda.max_memory_allocated()
    engine.sched.check_invariants()
    if engine.sched.pool.allocated_count != 0:
        raise AssertionError("pages still allocated after the xlstm trace")
    steps = int(st["decode_steps"])
    # every prompt prefills once through one kernel call per mLSTM layer and
    # decode never calls it; every model forward runs 2 spectral
    # projections a block
    per_prefill = n_periods(cfg) * (cfg.slstm_every - 1)
    per_forward = 2 * cfg.n_layers
    require_launches(launches, {"mlstm_chunk": per_prefill * len(trace),
                                "spectral_matmul": per_forward * (len(trace) + steps)})
    for r in trace:
        got = out[r.rid]
        if (engine.last_statuses.get(r.rid) != "finished" or len(got) != r.max_new_tokens
                or got.min() < 0 or got.max() >= cfg.vocab):
            raise AssertionError(f"xlstm request {r.rid}: status "
                                 f"{engine.last_statuses.get(r.rid)}, tokens {got}")
    print(f"[xlstm] {int(st['requests'])} requests, {int(st['prefill_tokens'])} prefill + "
          f"{int(st['generated_tokens'])} generated tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']:.1f} tok/s), {steps} decode steps, ITL p50 "
          f"{st['itl_p50_s'] * 1e3:.3f} ms p99 {st['itl_p99_s'] * 1e3:.3f} ms; launches "
          f"{launches} = {per_prefill} mlstm_chunk per prefilled request (0 in decode) and "
          f"{per_forward} spectral_matmul per forward ({len(trace)} prefills + {steps} "
          f"decode steps)")
    gap = check_oracles(engine, trace, out, trace, "xlstm")
    # diagnostic, not gated: the static path with batch-1 steps (the
    # engine's step is (slots, 1)); this model amplifies a rounding flip
    b1 = [static_logit_gaps(cfg, engine.params, r.prompt, out[r.rid], pcfg.max_seq,
                            device=device, rows=1) for r in trace[:2]]
    b1_gap = max(float(g.max()) for g in b1)
    print(f"[xlstm] diagnostic: the batch-1 static path, teacher-forced over requests 0-1: "
          f"largest gap {b1_gap:.3f} of the allowance, first gap > 1 at token "
          f"{[int(np.argmax(g > 1.0)) if g.max() > 1.0 else None for g in b1]}, "
          f"{sum(int(np.sum(g == 0.0)) for g in b1)}/{sum(len(g) for g in b1)} tokens exactly "
          f"its choice")
    with torch.no_grad():
        state = init_decode_state(cfg, 1, pcfg.max_seq, device=device)
        toks = torch.as_tensor(trace[0].prompt, dtype=torch.int64, device=device)[None]
        logits, state = prefill(engine.params, toks, cfg, state)
    finite = all(bool(torch.isfinite(t).all()) for key in recurrent_slot_axes(cfg)
                 for t in state[key].values())
    if (tuple(logits.shape) != (1, 1, cfg.vocab) or not bool(torch.isfinite(logits).all())
            or not finite):
        raise AssertionError(f"xlstm prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}, state finite {finite}")
    del state
    # the prompt path's host-clock cost: the longest prompt's prefill, and
    # the six sLSTM scans in it (a Python loop over tokens of small ops)
    long = max(trace, key=lambda r: r.prompt_len)
    toks = torch.as_tensor(long.prompt, dtype=torch.int64, device=device)[None]
    x = torch.randn((1, long.prompt_len, cfg.d_model), device=device).to(torch.bfloat16)
    with torch.no_grad():
        times = []
        for fn in (lambda: prefill(engine.params, toks, cfg,
                                   init_decode_state(cfg, 1, pcfg.max_seq, device=device)),
                   lambda: [xlstm_mod.apply_slstm_with_state(
                       layer_slice(engine.params["periods"], i)[f"p{cfg.slstm_offset}"]["slstm"],
                       x, cfg) for i in range(n_periods(cfg))]):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
    prefill_ms, slstm_ms = times
    print(f"[xlstm] one {long.prompt_len}-token prefill {prefill_ms:.1f} ms (host clock), of "
          f"which the {n_periods(cfg)} sLSTM scans {slstm_ms:.1f} ms")
    record = {"arch": cfg.name, "params": n_params, "weight_bytes": engine.weight_bytes,
              "recurrent_state_bytes": state_bytes, "requests": int(st["requests"]),
              "prefill_tokens": int(st["prefill_tokens"]),
              "generated_tokens": int(st["generated_tokens"]), "decode_steps": steps,
              "wall_s": st["wall_s"], "tokens_per_s": st["tokens_per_s"],
              "itl_gaps": st["itl_gaps"], "cold_itl_p50_ms": before["itl_p50_s"] * 1e3,
              "cold_itl_p99_ms": before["itl_p99_s"] * 1e3,
              "itl_p50_ms": st["itl_p50_s"] * 1e3, "itl_p99_ms": st["itl_p99_s"] * 1e3,
              "max_memory_allocated": peak_mem, "launches": launches,
              "identical_to_replay_alone": len(trace), "max_static_gap": gap,
              "batch1_static_max_gap": b1_gap, "prefill_160_ms": prefill_ms,
              "slstm_scans_160_ms": slstm_ms}
    return engine, record


def phase_xlstm_timing(torch, cfg, launches, errs):
    """The mLSTM kernel and its plain version at the cell's prefill shape
    (one 160-token prompt: B = 4 heads, dh 1024, empty state), in device
    time only. No single PyTorch call computes this function: no library
    time."""
    from repro_torch.kernels.mlstm_chunk import CHUNK, mlstm_chunk
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref
    from repro_torch.kernels.testing import mlstm_inputs

    B, S, dh = cfg.n_heads, MLSTM_PREFILL_S, 2 * cfg.d_model // cfg.n_heads
    q, k, v, i, f, _ = mlstm_inputs(B, S, dh, "unit", seed=SEED + 11, device="cuda")
    t = {"ms": time_cold(torch, lambda: mlstm_chunk(q, k, v, i, f)),
         "plain_ms": time_cold(torch, lambda: mlstm_chunk_ref(q, k, v, i, f, chunk=CHUNK,
                                                              ragged=True)),
         "library_ms": None}
    y, st = mlstm_chunk(q, k, v, i, f)
    yr, sr = mlstm_chunk_ref(q, k, v, i, f, chunk=CHUNK, ragged=True)
    for g, r in zip((y, *st), (yr, *sr)):
        add_err(t, g, r)
    # the work these inputs need: causal scores and w.S @ v (S (S+1) / 2
    # pairs x dh each), the state update (S dh^2) and n (S dh); the empty
    # state makes q @ C0 no work. Bytes: q, k, v, the gates in; y, C, n, m out
    pairs = S * (S + 1) // 2
    t["flops"] = 2 * B * (2 * pairs * dh + S * dh * dh + S * dh)
    t["bytes"] = 4 * B * (3 * S * dh + 2 * S + S * dh + dh * dh + dh + 1)
    return kernel_entry("mlstm_chunk", "src/repro_torch/csrc/mlstm_chunk.cu",
                        "src/repro/kernels/mlstm_chunk.py:82", t, "float32",
                        f"one {S}-token prompt's mLSTM layer: B={B} (1 request x {B} heads), "
                        f"S={S}, dh={dh}, empty state, fp32; no library call computes it",
                        launches, errs)


def phase_jamba_kernels(torch, cfg):
    """The selective-scan kernel against its plain version over the sweep
    (y and hT at the fp32 rung), its gap to the reference model's bf16
    scan (printed), the spectral kernel at jamba's MLP shapes and the
    paged decode at head dim 128."""
    from repro_torch.kernels.mamba_ref import mamba_scan_ref, mamba_scan_twin_ref
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.kernels.paged_ref import paged_gqa_decode_ref
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.kernels.testing import (
        MAMBA_PROFILES,
        compare_kernel,
        kernel_error,
        mamba_inputs,
        ragged_seq_lens,
    )

    errs = {}
    cases = 0
    ds = cfg.mamba_d_state
    for b in MAMBA_B:
        for S in MAMBA_S:
            for di in MAMBA_DI:
                for dtype in (torch.float32, torch.bfloat16):
                    for profile in MAMBA_PROFILES:
                        args = mamba_inputs(b, S, di, ds, profile, dtype=dtype, seed=SEED + S,
                                            device="cuda")
                        y, h = mamba_scan(*args)
                        yr, hr = mamba_scan_ref(*args)
                        for name, g, r in (("y", y, yr), ("hT", h, hr)):
                            note(errs, "mamba_scan", compare_kernel(
                                lambda: g, lambda: r, (), dtype=torch.float32,
                                label=f"mamba_scan {name} b={b} S={S} di={di} {dtype} "
                                      f"{profile}"))
                        cases += 1
    print(f"[kernels] mamba_scan: y and hT match the plain version at the fp32 rung over "
          f"{cases} cases (b {list(MAMBA_B)}, S {list(MAMBA_S)}, di {list(MAMBA_DI)}, fp32 "
          f"and bf16, dt profiles {list(MAMBA_PROFILES)}); max scaled error "
          f"{errs['mamba_scan'][1]:.3e}")
    di = cfg.mamba_expand * cfg.d_model
    args = mamba_inputs(1, MLSTM_PREFILL_S, di, ds, "unit", dtype=torch.bfloat16,
                        seed=SEED + 13, device="cuda")
    y, h = mamba_scan(*args)
    yt, ht = mamba_scan_twin_ref(*args)
    gy = kernel_error(yt.float().cpu().numpy(), y.float().cpu().numpy())
    gh = kernel_error(ht.float().cpu().numpy(), h.cpu().numpy())
    print(f"[kernels] mamba_scan vs the reference model's scan (h carried in bf16) at "
          f"b=1 S={MLSTM_PREFILL_S} di={di} bf16, not gated: y max scaled gap "
          f"{gy.max_scaled:.3e}, hT {gh.max_scaled:.3e}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    d, f, k = cfg.d_model, cfg.d_ff, cfg.sct.rank
    for dtype in (torch.bfloat16, torch.float32):
        for m, n in ((d, f), (f, d)):
            for M in (SLOTS, MLSTM_PREFILL_S):
                note(errs, "spectral_matmul", compare_kernel(
                    spectral_matmul, spectral_matmul_ref,
                    spectral_inputs(torch, M, m, n, k, dtype, gen),
                    label=f"spectral_matmul {M}x{m}->{n} rank {k} {dtype}"))
        n_pages = 12
        lens = ragged_seq_lens(SLOTS, PAGE * n_pages - 1, PAGE, seed=SEED + 1).tolist()
        pargs = paged_inputs(torch, lens, n_pages, cfg.n_kv_heads,
                             cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, dtype, gen,
                             null_slot=True)
        for part, what in ((slice(1, None), "live slots"), (slice(0, 1), "null slot")):
            note(errs, "paged_gqa_decode", compare_kernel(
                lambda *a: paged_gqa_decode(*a)[part],
                lambda *a: paged_gqa_decode_ref(*a)[part],
                pargs, label=f"paged_gqa_decode hd {cfg.head_dim} {dtype} {what}"))
    print(f"[kernels] spectral_matmul at jamba's MLP shapes ({d}->{f}, {f}->{d}, rank {k}, "
          f"M {SLOTS}/{MLSTM_PREFILL_S}) and paged_gqa_decode at hd {cfg.head_dim} (b "
          f"{SLOTS}, kvh {cfg.n_kv_heads}, rep {cfg.n_heads // cfg.n_kv_heads}, lens {lens}, "
          f"null slot), bf16 and fp32, match")
    torch.cuda.synchronize()
    return errs


def phase_jamba_serving(torch, device):
    """jamba-v0.1-52b at full width through the engine on slice 1's trace
    and geometry; returns (engine, record).

    The model is built with capacity_factor=8.0, the JAX package's tests'
    pin (``tests/test_serving.py:190``). Its MoE sizes each expert's
    capacity per forward; at 8.0 a decode step over 4 slots gives every
    expert 4 slots and drops nothing, so the engine's batched step routes
    each request as the request served alone and the static path do, and
    the identity gates mean something. At the config's 1.25 the capacity
    is 1: the rows of a step compete for it, and the reference's own CLI
    then reports 4 of 8 requests off its static path."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.lm import is_moe_layer, n_periods
    from repro_torch.models.model import init_decode_state, init_model, param_count, prefill
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedCacheConfig

    cfg = get_config(JAMBA_ARCH).replace(capacity_factor=JAMBA_CAPACITY)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    masters = init_model(cfg, seed=SEED, device=device)
    n_params = param_count(masters)
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=NUM_PAGES, max_slots=SLOTS,
                            max_pages_per_seq=PAGES_PER_SEQ)
    engine = ServingEngine(cfg, masters, pcfg, device=device, prefill_token_budget=64)
    del masters                                 # the engine holds its bf16 copy
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    a_log = engine.params["periods"]["p0"]["mamba"]["A_log"]
    if a_log.dtype != torch.float32:
        raise AssertionError(f"mamba's A_log is served in {a_log.dtype}, not fp32")
    state_bytes = engine.recurrent_state_bytes()
    pool_bytes = engine.attn_cache_bytes()
    P = n_periods(cfg)
    print(f"[jamba] {cfg.name}: {n_params} parameters, {cfg.n_layers} layers ({P} periods of "
          f"{cfg.attn_every - 1} mamba + 1 attention), {cfg.n_experts} experts top-"
          f"{cfg.top_k} every {cfg.moe_every} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, rank {cfg.sct.rank}, {cfg.dtype}, capacity factor "
          f"{cfg.capacity_factor}; weight_bytes {engine.weight_bytes}, recurrent state "
          f"{state_bytes} bytes ({SLOTS} slots), paged pools {pool_bytes} bytes; init + load "
          f"{time.time() - t0:.1f} s, peak device memory {init_peak} bytes")
    engine.run(make_trace(cfg.vocab, SEED + 3, rid0=len(TRACE)))       # warm-up
    before = engine.stats()
    trace = make_trace(cfg.vocab, SEED)
    torch.cuda.reset_peak_memory_stats()
    out, launches, st = run_measured(torch, engine, trace)
    peak_mem = torch.cuda.max_memory_allocated()
    engine.sched.check_invariants()
    if engine.sched.pool.allocated_count != 0:
        raise AssertionError("pages still allocated after the jamba trace")
    steps = int(st["decode_steps"])
    # every prompt prefills once through one scan a mamba layer, decode never
    # scans; the dense MLPs (3 spectral projections each) are the only
    # spectral layers; one paged decode an attention layer and step
    per_prefill = P * (cfg.attn_every - 1)
    per_forward = 3 * P * sum(not is_moe_layer(cfg, p) for p in range(cfg.attn_every))
    require_launches(launches, {"mamba_scan": per_prefill * len(trace),
                                "spectral_matmul": per_forward * (len(trace) + steps),
                                "paged_gqa_decode": P * steps,
                                "flash_attention_fwd": 0, "flash_attention_bwd": 0})
    for r in trace:
        got = out[r.rid]
        if (engine.last_statuses.get(r.rid) != "finished" or len(got) != r.max_new_tokens
                or got.min() < 0 or got.max() >= cfg.vocab):
            raise AssertionError(f"jamba request {r.rid}: status "
                                 f"{engine.last_statuses.get(r.rid)}, tokens {got}")
    print(f"[jamba] {int(st['requests'])} requests, {int(st['prefill_tokens'])} prefill + "
          f"{int(st['generated_tokens'])} generated tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']:.1f} tok/s), {steps} decode steps, ITL p50 "
          f"{st['itl_p50_s'] * 1e3:.3f} ms p99 {st['itl_p99_s'] * 1e3:.3f} ms, peak device "
          f"memory {peak_mem} bytes; launches {launches} = {per_prefill} mamba_scan per "
          f"prefilled request (0 in decode), {per_forward} spectral_matmul per forward "
          f"({len(trace)} prefills + {steps} decode steps), {P} paged_gqa_decode per step")
    gap = check_oracles(engine, trace, out, trace, "jamba")
    with torch.no_grad():
        state = init_decode_state(cfg, 1, pcfg.max_seq, device=device)
        toks = torch.as_tensor(trace[0].prompt, dtype=torch.int64, device=device)[None]
        logits, state = prefill(engine.params, toks, cfg, state)
    finite = all(bool(torch.isfinite(t).all()) for part in state.values()
                 for t in part.values())
    if (tuple(logits.shape) != (1, 1, cfg.vocab) or not bool(torch.isfinite(logits).all())
            or not finite):
        raise AssertionError(f"jamba prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}, state finite {finite}")
    del state
    # the prompt path's host-clock cost: the longest prompt's prefill
    long = max(trace, key=lambda r: r.prompt_len)
    toks = torch.as_tensor(long.prompt, dtype=torch.int64, device=device)[None]
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prefill(engine.params, toks, cfg, init_decode_state(cfg, 1, long.prompt_len,
                                                                 device=device))
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t1) * 1e3
    print(f"[jamba] one {long.prompt_len}-token prefill {prefill_ms:.1f} ms (host clock)")
    record = {"arch": cfg.name, "params": n_params, "capacity_factor": cfg.capacity_factor,
              "weight_bytes": engine.weight_bytes, "recurrent_state_bytes": state_bytes,
              "attn_cache_bytes": pool_bytes, "init_peak_memory": init_peak,
              "requests": int(st["requests"]), "prefill_tokens": int(st["prefill_tokens"]),
              "generated_tokens": int(st["generated_tokens"]), "decode_steps": steps,
              "wall_s": st["wall_s"], "tokens_per_s": st["tokens_per_s"],
              "itl_gaps": st["itl_gaps"], "cold_itl_p50_ms": before["itl_p50_s"] * 1e3,
              "cold_itl_p99_ms": before["itl_p99_s"] * 1e3,
              "itl_p50_ms": st["itl_p50_s"] * 1e3, "itl_p99_ms": st["itl_p99_s"] * 1e3,
              "max_memory_allocated": peak_mem, "launches": launches,
              "identical_to_replay_alone": len(trace), "max_static_gap": gap,
              "prefill_160_ms": prefill_ms}
    return engine, record


def phase_jamba_timing(torch, cfg, launches, errs):
    """The scan kernel and its plain version at one 160-token prompt's
    mamba layer (b 1, di 8192, d_state 16, bf16; A and D in bf16 as the
    model hands them over), in device time only. No single PyTorch call
    computes a selective scan: no library time."""
    from repro_torch.kernels.mamba_ref import mamba_scan_ref
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.testing import mamba_inputs

    S, di, ds = MLSTM_PREFILL_S, cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    u, dt, B, C, A, D = mamba_inputs(1, S, di, ds, "unit", dtype=torch.bfloat16,
                                     seed=SEED + 12, device="cuda")
    A, D = A.bfloat16(), D.bfloat16()
    t = {"ms": time_cold(torch, lambda: mamba_scan(u, dt, B, C, A, D)),
         "plain_ms": time_cold(torch, lambda: mamba_scan_ref(u, dt, B, C, A, D)),
         "library_ms": None}
    y, h = mamba_scan(u, dt, B, C, A, D)
    yr, hr = mamba_scan_ref(u, dt, B, C, A, D)
    add_err(t, y, yr)
    add_err(t, h, hr)
    # bytes: u, dt, B, C, A, D in (bf16) and y (bf16), hT (fp32) out; the
    # operations a (step, channel): dt u, u D and the sum's add, and a state
    # dt A, dA h, du B, their sum, h C and its add
    t["bytes"] = 2 * (3 * S * di + 2 * S * ds + di * ds + di) + 4 * di * ds
    t["flops"] = S * di * (6 * ds + 3)
    return kernel_entry("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                        "src/repro/kernels/mamba_scan.py:52", t, "float32",
                        f"one {S}-token prompt's mamba layer: b=1, S={S}, di={di}, "
                        f"d_state={ds}, bf16 in and out, fp32 state; no library call "
                        f"computes it", launches, errs)


def device_rows(torch, prof):
    """(device ms, launches, kernel name) of every device kernel row of a
    profile, largest first (host ops are skipped: their kernels are rows
    of their own)."""
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def bound_of(t, peak_key):
    """The least time for the work: the larger of the bytes over HBM
    bandwidth and the operations over the peak rate."""
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["flops"] / PEAK_FLOPS[peak_key] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def note(errs, name, e):
    """Fold one check's (max abs, max RMS-scaled) error into ``errs``."""
    raw, scaled = errs.get(name, (0.0, 0.0))
    errs[name] = (max(raw, e[0]), max(scaled, e[1]))


def merge_errs(errs, more):
    for name, e in more.items():
        note(errs, name, e)


def add_err(t, y, yr):
    """Fold the error of a timed kernel's output ``y`` against its plain
    version's ``yr`` into ``t["err"]`` (max abs) and ``t["scaled"]``."""
    from repro_torch.kernels.testing import kernel_error

    e = kernel_error(y.detach().float().cpu().numpy(), yr.detach().float().cpu().numpy())
    t["err"] = max(t.get("err", 0.0), e.max_abs)
    t["scaled"] = max(t.get("scaled", 0.0), e.max_scaled)


def kernel_entry(name, source, replaces, t, peak_key, shape, launches, errs):
    """One entry of the ``kernels`` line. ``max_abs_err`` is the error at
    the timed shape; ``max_err`` the largest unscaled error of every
    check; ``max_scaled_err`` the largest error of every check divided by
    its reference's RMS, the quantity the ladder's rung bounds (fp32
    5e-5, bf16 5e-2, plus rtol times |ref| / RMS)."""
    raw, scaled = errs.get(name, (0.0, 0.0))
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches.get(name, 0), "max_abs_err": t["err"],
        "max_err": max(t["err"], raw), "max_scaled_err": max(t["scaled"], scaled),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        **bound_of(t, peak_key),
        "library_ms": t["library_ms"], "shape": shape,
    }
    if "library_fwd_bwd_ms" in t:
        entry["library_fwd_bwd_ms"] = t["library_fwd_bwd_ms"]
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port's package is not next to this script ({e})")
    from repro_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    device = torch.device("cuda", 0)
    cfg = get_config("llama3.2-1b")
    train_cfg = get_config(TRAIN_ARCH)
    t_start = time.time()
    clock = {}

    def lap(name):
        clock[name] = time.time() - t_start - sum(clock.values())

    try:
        phase_build()
        lap("build")
        print(f"[card] {smi}")
        errs = phase_kernels(torch, cfg)
        merge_errs(errs, phase_train_kernels(torch, train_cfg))
        lap("kernel checks")
        merge_errs(errs, phase_int8_kernels(torch, cfg))
        lap("int8 kernel checks")
        engine, trace, serving = phase_serving(torch, cfg, device)
        kernels = phase_timing(torch, cfg, engine, trace, serving["launches"], errs)
        serving["profile"] = phase_profile(torch, cfg, engine)
        bf16_weight_bytes = engine.weight_bytes
        del engine
        torch.cuda.empty_cache()
        lap("serving")
        from repro_torch.models.model import init_model

        masters = init_model(cfg, seed=SEED, device=device)
        engine, int8 = phase_int8_serving(torch, cfg, device, masters, bf16_weight_bytes)
        int8["profile"] = phase_profile(torch, cfg, engine)
        del engine
        lap("int8 serving")
        engine, stream = phase_streaming(torch, cfg, device, masters)
        stream["profile"] = phase_profile(torch, cfg, engine)
        del engine, masters
        torch.cuda.empty_cache()
        lap("streaming")
        xlstm_cfg = get_config(XLSTM_ARCH)
        merge_errs(errs, phase_xlstm_kernels(torch, xlstm_cfg))
        lap("xlstm kernel checks")
        engine, xlstm = phase_xlstm_serving(torch, device)
        # short prompts: the sLSTM's prefill scan is a host loop of small ops
        # (thousands of profiler events a prompt); the stretch is about decode
        xlstm["profile"] = phase_profile(torch, xlstm_cfg, engine, prompt_len=16)
        del engine
        torch.cuda.empty_cache()
        lap("xlstm serving")
        kernel_mlstm = phase_xlstm_timing(torch, xlstm_cfg, xlstm["launches"], errs)
        lap("xlstm timing")
        jamba_cfg = get_config(JAMBA_ARCH)
        merge_errs(errs, phase_jamba_kernels(torch, jamba_cfg))
        lap("jamba kernel checks")
        engine, jamba = phase_jamba_serving(torch, device)
        jamba["profile"] = phase_profile(torch, engine.cfg, engine)
        del engine
        torch.cuda.empty_cache()
        lap("jamba serving")
        kernel_mamba = phase_jamba_timing(torch, jamba_cfg, jamba["launches"], errs)
        lap("jamba timing")
        kernels_int8 = phase_int8_timing(torch, cfg, int8["launches"], stream["launches"],
                                         errs)
        lap("int8 timing")
        train = phase_training(torch, device)
        torch.cuda.empty_cache()
        train["resume"] = phase_resume(torch, device)
        lap("training")
        flash, at_train = phase_train_timing(torch, train_cfg, train["launches"], errs)
        lap("training timing")
    except Exception:                            # every phase failure fails the run
        traceback.print_exc()
        return fail("a phase failed")
    kernels[0]["launches_train"] = train["launches"]["spectral_matmul"]
    kernels[0]["at_train_shape"] = {key: at_train[key] for key in (
        "shape", "ms", "plain_ms", "library_ms", "max_abs_err", "max_scaled_err", "bound_ms",
        "bound_by")}
    kernels += flash
    kernels_int8[0]["launches_streaming"] = stream["launches"].get("spectral_matmul_q8", 0)
    kernels[0]["launches_xlstm"] = xlstm["launches"].get("spectral_matmul", 0)
    kernels[0]["launches_jamba"] = jamba["launches"].get("spectral_matmul", 0)
    kernels[1]["launches_jamba"] = jamba["launches"].get("paged_gqa_decode", 0)
    kernels += kernels_int8 + [kernel_mlstm, kernel_mamba]
    for kern in kernels:                        # checks of later phases count too
        raw, scaled = errs.get(kern["name"], (0.0, 0.0))
        kern["max_err"] = max(kern["max_err"], raw)
        kern["max_scaled_err"] = max(kern["max_scaled_err"], scaled)
    extra = [dict(at_train, name="spectral_matmul (training shape)",
                  launches=train["launches"]["spectral_matmul"]),
             dict(kernels_int8[0]["at_prefill_chunk"], name="spectral_matmul_q8 (prefill chunk)",
                  launches=kernels_int8[0]["launches"])]
    for kern in kernels + extra:
        lib = "none" if kern["library_ms"] is None else f"{kern['library_ms']:.4f} ms"
        print(f"[timing] {kern['name']}: {kern['ms']:.4f} ms kernel, "
              f"{kern['plain_ms']:.4f} ms plain, library {lib}, "
              f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), "
              f"{kern['launches']} launches on the main path ({kern['shape']})")
    print(f"[total] {time.time() - t_start:.1f} s: "
          + ", ".join(f"{name} {sec:.1f} s" for name, sec in clock.items()))
    print(smi)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"int8_serving": int8}))
    print(json.dumps({"streaming": stream}))
    print(json.dumps({"xlstm_serving": xlstm}))
    print(json.dumps({"jamba_serving": jamba}))
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
