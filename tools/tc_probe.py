#!/usr/bin/env python3
"""Check and time the port's tensor-core kernels on one GPU: the bf16
spectral matmul and the int8 one on bf16 activations
(``csrc/spectral_matmul_tc.cu``), and the bf16 flash forward and backward
(``csrc/flash_attention.cu``, the ``*_tc_kernel``s).

    PYTHONPATH=src python3 tools/tc_probe.py [--fwd] [--q8] [--mla] [--mlstm] [--mlstm-bwd]
                                             [--gqa] [--mamba] [--mamba-bwd]
                                             [--quick | --split] [--time-only] [--src DIR]

With no mode flag: the bf16 spectral kernel and the flash backward. It
builds the kernels, prints each kernel's registers and spills, holds both
against their plain versions at the main paths' shapes, checks the
spectral kernel's batch invariance (rows of M = 1/4/37/64/160/8192 against
the row alone) and the backward's determinism, then times, with
``chip_smoke.time_cold`` (cold-L2 device-time medians): one decode
layer's MLP (3 launches, M 4), the 64-row prefill chunk, both training
projections (M 8192), against the plain version and the three-GEMM
chain; the flash backward at smollm2-1.7b's training shape against SDPA's
backward. ``--split`` adds each backward kernel's device time
(``torch.profiler``) and the spectral kernel at shapes that leave one
phase (a 256-wide m or n).

``--fwd``: the flash forward's (out, m, l) against its plain version (r 1,
4 and 64, head dims 64 and 128, ragged lengths, causal and not), two calls
bit-identical, the backward run from the kernel forward's (out, m, l)
against the plain pair; the kv tiles the training shape's query tiles
walk; its time there against SDPA and the bound. ``--q8``: the int8
kernel in bf16 against its plain version on every check shape and scale
profile, every row of M = 1/4/37/64/160/256 equal to the row alone on
both MLP shapes, its launch geometry; its time at one decode layer (3
launches, M 4) and a 64-row prefill chunk, its gain computed beforehand,
against the plain version, the three-GEMM chain over pre-dequantized
factors and the bf16 kernel on those factors. ``--mla``: the absorbed-MLA
decode, hot and cold (``csrc/paged_mla_decode.cu``), against its plain
versions at deepseek-v3-671b's width (b 1 and 4, ragged lengths, a null
slot, fp32 and bf16 q, p_cold 0/0.5/1, live pages fewer than the table) and
at ragged small widths (h 20, latent 32, rope 12, page 3); two calls the same
bits, the cold kernel with no page flagged the hot one's bits; its launch
geometry and time at ``chip_smoke.py``'s timed shapes. ``--mlstm``: the
chunkwise mLSTM (``csrc/mlstm_chunk.cu``) against its plain version in the
kernel's chunks (S 1 to 1000, dh 32 and 1024, both gate profiles, with and
without a state), two calls the same bits, and a digest of each case's
bits (to hold two trees' bits equal); its time at the xlstm prefill shape
(B 4, S 160, dh 1024) and with a state. ``--mlstm-bwd``: the mLSTM
backward (``csrc/mlstm_chunk_bwd.cu``) against its plain version at the
card tests' cases and at xlstm-1.3b's training shape (B 8, S 4096, dh
1024), both gate profiles, with and without a state and gradients of the
final state (every skip path of the plan), at the fp32 rung scaled as
``chip_smoke.py``'s phase K scales it, two calls the same bits, and at
phase K's worst case each gradient of kernel and plain version against the
plain version in fp64; its time
at the training shape (empty state, no gradient of the final state):
the call's cold-L2 median and each of its six launches' device time; and
the rates of ``tools/mma_floors.cu`` (mma.sync in tf32, wgmma in tf32,
mma.sync in fp64 at three shapes, each on a full card). ``--gqa``: the paged GQA
decode, hot and cold (``csrc/paged_decode.cu``), against its plain versions
at every case of the card tests (256- and 600-page tables among them;
ragged lengths, a null slot, fp32 and bf16 q, p_cold 0/0.5/1): two calls
the same bits, every row the slot's row computed alone at the same table
width, the cold kernel with no page flagged the hot one's bits; its time
at ``chip_smoke.py``'s two timed shapes, at jamba's hd 128 and at a
256-page table (4095 tokens a slot), hot and cold, against the plain
version and the bytes bound (one launch each: no ``--split``). ``--mamba``: the selective
scan (``csrc/mamba_scan.cu``) against its plain version at every case of
the card tests and on the model's layout (A and D in bf16, B and C column
views of ``x_proj``'s output), two calls the same bits, one device kernel a
call; its time at jamba's prompt (b 1, S 160, di 8192, d_state 16, bf16)
and at S 4096: the kernel alone (contiguous B and C, fp32 A and D), the op
on the model's layout, the device kernels the op runs, the plain version,
the bytes bound; and the floors of ``tools/mamba_floors.cu`` (an empty
kernel of the scan's grid, one round of loads, the exponentials alone on a
full card: accurate expf, exp2f, ex2.approx). ``--mamba-bwd``: the
selective scan's backward (``csrc/mamba_scan_bwd.cu``): its walk's blocks
an SM at every built d_state (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
where the tree's library exports it); against its plain version at the
card tests' cases and jamba's training shape (fp32 and bf16, both dt
profiles, with and without the final state's gradient) at the fp32 rung,
two calls the same bits, one count a call, and how many cases are the
plain version's bits; a digest of the bits of #8 (recording or not) and
#8b at jamba's prompt and training shapes on the model's layout (to hold
two trees' bits equal); its time at the training shape (b 2, S 4096, di
8192, d_state 16, bf16, no final-state gradient): the call's cold-L2
median and the walk's and the reduction's device time, beside its bounds
(fp32 at 67 TFLOP/s, and one unfused operation a lane-clock).
``--quick`` skips the timing, ``--time-only`` the checks. ``--src DIR`` imports the port from
another checkout's ``src`` (its kernels build there), so that two trees
can be timed in one call. Needs no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MLP_SHAPES = ((2048, 8192), (8192, 2048))   # llama3.2-1b's MLP: up/gate, down
RANK = 128


def demangle(name: str) -> str:
    """A kernel's C++ name (c++filt where the host has it), without its
    anonymous namespace and argument list."""
    try:
        name = subprocess.run(["c++filt"], input=name, capture_output=True, text=True,
                              timeout=10).stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        return name
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def print_ptxas(build, sources, only=None):
    """Registers, shared memory and spills of each kernel of ``sources``
    (ptxas -v), under the kernel's name; ``only``: a substring the name
    must hold."""
    for src, report in build.BUILD_LOG.get("ptxas", {}).items():
        if src not in sources:
            continue
        func = "?"
        for line in report.splitlines():
            if "Compiling entry function" in line:
                func = demangle(line.split("'")[1] if "'" in line else line)
            elif ("registers" in line or "spill" in line) and (only is None or only in func):
                print(f"[build] {src} {func}: {line.split(':', 1)[-1].strip()}")


def fwd_mode(torch, cs, gen, args):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref
    from repro_torch.kernels.testing import compare_kernel

    bf = torch.bfloat16
    if not args.time_only:
        for case, causal in (((1, 256, 4, 1, 64), True), ((1, 1000, 2, 4, 64), True),
                             ((1, 4096, 2, 4, 64), True), ((2, 4096, 32, 1, 64), True),
                             ((1, 200, 1, 64, 64), True), ((1, 130, 2, 64, 128), True),
                             ((2, 256, 2, 2, 128), True), ((1, 300, 1, 3, 64), True),
                             ((1, 1000, 2, 4, 64), False), ((1, 300, 1, 3, 128), False)):
            q, kk, v, do = cs.flash_inputs(torch, *case, bf, gen)
            got = flash_attention_fwd(q, kk, v, causal)
            ref = flash_fwd_ref(q, kk, v, causal)
            again = flash_attention_fwd(q, kk, v, causal)
            for name, g1, g2, r1 in zip(("out", "m", "l"), got, again, ref):
                e = compare_kernel(lambda: g1, lambda: r1, (), dtype=bf,
                                   label=f"flash fwd {name} {case} causal={causal}")
                if not torch.equal(g1, g2):
                    raise AssertionError(f"flash fwd {name} {case}: two calls differ")
                print(f"[flash_fwd] {case} causal={causal} {name}: max abs {e.max_abs:.3e}, "
                      f"scaled {e.max_scaled:.3e}, deterministic")
            # the backward run from the kernel forward's (out, m, l), against
            # its plain version on the same inputs
            grads = flash_attention_bwd(q, kk, v, *got, do, causal)
            ref_grads = flash_bwd_ref(q, kk, v, *got, do, causal)
            for name, g1, r1 in zip(("dq", "dk", "dv"), grads, ref_grads):
                e = compare_kernel(lambda: g1, lambda: r1, (), label=f"bwd after fwd {name}")
                print(f"[flash_fwd] {case} causal={causal} backward {name} from the kernel's "
                      f"(out, m, l): max abs {e.max_abs:.3e}, scaled {e.max_scaled:.3e}")
            del q, kk, v, do, got, ref, again, grads, ref_grads
        torch.cuda.synchronize()
    b, s_, h, d = 2, 4096, 32, 64
    # trip counts at the training shape: each 64-row query tile (64
    # positions at r 1) walks the 64-row kv tiles up to its last position
    walks = [min(s_, 64 * (i + 1)) // 64 for i in range(s_ // 64)]
    print(f"[flash_fwd] training shape: {b * h * len(walks)} query tiles, kv tiles a query "
          f"tile walks min {min(walks)} mean {sum(walks) / len(walks):.1f} max {max(walks)}; "
          f"{b * h * sum(walks)} tile products of each kind")
    if args.quick:
        return
    q, kk, v, _ = cs.flash_inputs(torch, b, s_, h, 1, d, bf, gen)
    ms = cs.time_cold(torch, lambda: flash_attention_fwd(q, kk, v))

    def heads(t):
        return t.reshape(b, s_, h, d).transpose(1, 2).contiguous()

    qh, kh, vh = heads(q), heads(kk[:, :, :, None]), heads(v[:, :, :, None])
    lib = cs.time_cold(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                    is_causal=True))
    flops = 2 * 2 * b * h * s_ * s_ * d / 2
    print(f"[time] flash_attention_fwd ({b}, {s_}, {h} heads, d {d}): kernel {ms:.4f} ms, "
          f"SDPA {lib:.4f}, bound {flops / cs.PEAK_FLOPS['bfloat16'] * 1e3:.4f} "
          f"(operations), {flops / ms / 1e9:.1f} TFLOP/s")


def mla_mode(torch, cs, args):
    from repro_torch.kernels.paged_decode import paged_mla_decode, paged_mla_decode_cold
    from repro_torch.kernels.spectral_matmul import _sm_count
    from repro_torch.kernels.paged_ref import paged_mla_decode_cold_ref, paged_mla_decode_ref
    from repro_torch.kernels.testing import compare_kernel, ragged_seq_lens

    cfg = cs.deepseek_config(cs.DEEPSEEK_LAYERS)
    scale = cs.mla_scale(cfg)
    sms = _sm_count(0)
    hot_lens = [p + g // 2 for p, g in cs.TRACE[:cs.SLOTS]]
    cold_lens = [cs.SINK * cs.PAGE + cs.WINDOW * cs.PAGE + cs.PAGE - 1] * cs.STREAM_SLOTS
    for name, lens, n_pages in ((("hot", hot_lens, cs.PAGES_PER_SEQ),
                                 ("cold", cold_lens, cs.STREAM_PAGES_PER_SEQ))
                                if not args.time_only else ()):
        from repro_torch.kernels.paged_decode import mla_geometry, mla_items
        ppi, per_slot = mla_geometry(len(lens), cfg.n_heads, n_pages, sms)
        items = mla_items(lens, cs.PAGE, n_pages, ppi)
        print(f"[mla] {name} shape: lens {lens}, table {n_pages}: {ppi} page(s) an item, grid "
              f"{len(lens) * per_slot} x {-(-cfg.n_heads // 64)}, {len(items)} live items")

    def small(case, dtype, p_cold=None, seed=0):
        from repro_torch.kernels.testing import mla_inputs
        b, h, lat, rope, page, n = case
        lens = ragged_seq_lens(b, page * n - 1, page, seed=seed).tolist()
        return mla_inputs(lens, n, h, lat, rope, page, dtype=dtype, null_slot=b > 1,
                          p_cold=p_cold, seed=seed, device="cuda")

    def check(args, cold, what, dtype):
        kern = paged_mla_decode_cold if cold else paged_mla_decode
        ref = paged_mla_decode_cold_ref if cold else paged_mla_decode_ref
        b = args[0].shape[0]
        parts = (slice(1, None), slice(0, 1)) if b > 1 else (slice(None),)
        worst = 0.0
        for part in parts:
            e = compare_kernel(lambda *a: kern(*a, scale=scale)[part],
                               lambda *a: ref(*a, scale=scale)[part], args, dtype=dtype,
                               label=f"mla {what}")
            worst = max(worst, e.max_scaled)
        if not torch.equal(kern(*args, scale=scale), kern(*args, scale=scale)):
            raise AssertionError(f"mla {what}: two calls differ")
        return worst

    if not args.time_only:
        for dtype in (torch.float32, torch.bfloat16):
            for lens, n_pages, null in (([cs.PAGE * 12 - 7], 12, False),
                                        (ragged_seq_lens(4, cs.PAGE * 12 - 1, cs.PAGE,
                                                         seed=cs.SEED).tolist(), 12, True),
                                        (hot_lens, cs.PAGES_PER_SEQ, False),
                                        (cold_lens, cs.STREAM_PAGES_PER_SEQ, False),
                                        ([3, 20, 0, 40], 16, False)):
                args_h = cs.mla_case(torch, lens, n_pages, cfg, dtype, null_slot=null)
                e = check(args_h, False, f"hot {lens} {dtype}", dtype)
                worst = [e]
                for p_cold in (0.0, 0.5, 1.0):
                    ca = cs.mla_case(torch, lens, n_pages, cfg, dtype, null_slot=null,
                                     p_cold=p_cold, seed=cs.SEED + 10)
                    worst.append(check(ca, True, f"cold {p_cold} {lens} {dtype}", dtype))
                    if p_cold == 0.0 and not torch.equal(
                            paged_mla_decode_cold(*ca, scale=scale),
                            paged_mla_decode(*ca[:4], ca[8], ca[9], scale=scale)):
                        raise AssertionError("mla: the cold kernel with no flag differs "
                                             "from the hot one")
                print(f"[mla] lens {lens} table {n_pages} {dtype}: hot and cold (p_cold "
                      f"0/0.5/1) match, deterministic; max scaled {max(worst):.3e}")
            for case in ((3, 4, 16, 8, 4, 6), (4, 20, 32, 12, 3, 5), (2, 16, 512, 64, 16, 4),
                         (2, 72, 64, 16, 40, 3)):
                worst = [check(small(case, dtype), False, f"{case}", dtype)]
                for p_cold in (0.5, 1.0):
                    worst.append(check(small(case, dtype, p_cold), True, f"{case} {p_cold}",
                                       dtype))
                print(f"[mla] {case} {dtype}: hot and cold match; max scaled {max(worst):.3e}")
        torch.cuda.synchronize()
    if args.quick:
        return
    for name, lens, n_pages, p_cold in (("paged_mla_decode", hot_lens, cs.PAGES_PER_SEQ, None),
                                        ("paged_mla_decode_cold", cold_lens,
                                         cs.STREAM_PAGES_PER_SEQ, 0.0)):
        a = cs.mla_case(torch, lens, n_pages, cfg, torch.float32, null_slot=False,
                        p_cold=p_cold, seed=cs.SEED + 17)
        if p_cold is None:
            kern, plain = paged_mla_decode, paged_mla_decode_ref
        else:
            a[10][a[8][:, cs.SINK].long()] = 1          # one cold page a slot
            kern, plain = paged_mla_decode_cold, paged_mla_decode_cold_ref
        ms = cs.time_cold(torch, lambda: kern(*a, scale=scale))
        pl = cs.time_cold(torch, lambda: plain(*a, scale=scale))
        flops = 2 * cfg.n_heads * sum(n + 1 for n in lens) * (2 * cfg.kv_lora_rank
                                                              + cfg.qk_rope_dim)
        print(f"[time] {name} (lens {lens}): kernel {ms:.4f} ms, plain {pl:.4f}, bound "
              f"{flops / cs.PEAK_FLOPS['float32'] * 1e3:.4f} (operations)")
        if args.split:                  # pages an item, and each launch's device time
            from repro_torch.kernels import paged_decode as pd
            from repro_torch.kernels.build import library
            fn = getattr(library(), "sct_" + name)
            cold = () if p_cold is None else a[4:8] + a[10:11]
            for ppi in (1, 2, 3, 4, 6):
                t = cs.time_cold(torch, lambda: pd._mla_launch(
                    name, fn, *a[:4], a[-3 if p_cold is not None else 4],
                    a[-2 if p_cold is not None else 5], scale, cold=cold, ppi=ppi))
                print(f"[split] {name}: {ppi} page(s) an item: {t:.4f} ms")
            profile_split(torch, cs, lambda: kern(*a, scale=scale))


def profile_split(torch, cs, fn):
    """Each launch's device time of ``fn()`` (torch.profiler, five calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    for ms_all, count, key in cs.device_rows(torch, prof)[:6]:
        print(f"[split] {demangle(key)[:60]}: {ms_all / count:.4f} ms a launch, {count} launches")


# (b, kvh, rep, hd, page, table width) of the GQA decode checks: the card
# tests' cases (tests/test_torch_kernels_cuda.py PAGED), 256- and 600-page
# tables among them (the second past 32 units a warp)
GQA_CHECKS = [(5, 2, 3, 64, 4, 6), (4, 1, 4, 20, 3, 5), (4, 4, 1, 48, 8, 4),
              (8, 8, 4, 64, 16, 12), (4, 8, 4, 128, 16, 12), (4, 8, 4, 64, 16, 256),
              (2, 4, 2, 64, 16, 600)]


def gqa_timed_cases(torch, cs):
    """{name: (kernel, plain, args, bytes)} at chip_smoke.py's two timed
    shapes (hot: lengths 40/176/87/128 in 16-page tables; cold: 95 tokens
    a slot in 8-page tables, one cold page a slot), at jamba's hd 128 and
    at a 256-page table (4095 tokens a slot)."""
    from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold
    from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref, paged_gqa_decode_ref

    hot_lens = [p + g // 2 for p, g in cs.TRACE[:cs.SLOTS]]
    cold_lens = [cs.SINK * cs.PAGE + cs.WINDOW * cs.PAGE + cs.PAGE - 1] * cs.STREAM_SLOTS
    long_lens = [256 * cs.PAGE - 1] * 4
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    cases = {}
    for name, lens, n, hd in (("hot", hot_lens, cs.PAGES_PER_SEQ, 64),
                              ("hd128", hot_lens, cs.PAGES_PER_SEQ, 128),
                              ("table256", long_lens, 256, 64)):
        a = cs.paged_inputs(torch, lens, n, 8, 4, hd, bf, gen, null_slot=False)
        nbytes = 2 * sum(x + 1 for x in lens) * 8 * hd * 2 + 2 * a[0].numel() * 2
        cases[name] = (paged_gqa_decode, paged_gqa_decode_ref, a, nbytes)
    for name, lens, n, hd in (("cold", cold_lens, cs.STREAM_PAGES_PER_SEQ, 64),
                              ("cold_table256", long_lens, 256, 64)):
        a = cs.cold_inputs(torch, lens, n, 8, 4, hd, bf, gen, null_slot=False, p_cold=0.0)
        a[9][a[7][:, cs.SINK].long()] = 1          # one cold page a slot
        rows = sum(x + 1 for x in lens) - len(lens) * cs.PAGE
        nbytes = (2 * rows * 8 * hd * 2 + 2 * len(lens) * cs.PAGE * 8 * hd
                  + 2 * len(lens) * 8 * hd * 4 + 2 * a[0].numel() * 2)
        cases[name] = (paged_gqa_decode_cold, paged_gqa_decode_cold_ref, a, nbytes)
    return cases


def gqa_mode(torch, cs, args):
    from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold
    from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref, paged_gqa_decode_ref

    def check(a, cold, what, dtype):
        from repro_torch.kernels.testing import compare_kernel

        kern = paged_gqa_decode_cold if cold else paged_gqa_decode
        ref = paged_gqa_decode_cold_ref if cold else paged_gqa_decode_ref
        worst = 0.0
        for part in (slice(1, None), slice(0, 1)):     # live slots, then the null slot
            e = compare_kernel(lambda *x: kern(*x)[part], lambda *x: ref(*x)[part], a,
                               dtype=dtype, label=f"gqa {what}")
            worst = max(worst, e.max_scaled)
        cs.require_rows_alone(torch, kern, a, (0, 7, 8) if cold else (0, 3, 4),
                              f"gqa {what}")
        return worst

    if not args.time_only:              # (another tree's port may lack these)
        from repro_torch.kernels.paged_decode import gqa_geometry
        from repro_torch.kernels.testing import gqa_inputs, ragged_seq_lens

        for case in GQA_CHECKS:
            b, kvh, rep, hd, page, n = case
            lens = ragged_seq_lens(b, page * n - 1, page, seed=cs.SEED).tolist()
            for dtype in (torch.float32, torch.bfloat16):
                hot = gqa_inputs(lens, n, kvh, rep, hd, page, dtype=dtype, null_slot=True,
                                 device="cuda")
                worst = [check(hot, False, f"hot {case} {dtype}", dtype)]
                for p_cold in (0.0, 0.5, 1.0):
                    ca = gqa_inputs(lens, n, kvh, rep, hd, page, dtype=dtype, null_slot=True,
                                    p_cold=p_cold, seed=cs.SEED + 10, device="cuda")
                    worst.append(check(ca, True, f"cold {p_cold} {case} {dtype}", dtype))
                    if p_cold == 0.0 and not torch.equal(
                            paged_gqa_decode_cold(*ca),
                            paged_gqa_decode(*ca[:3], ca[7], ca[8])):
                        raise AssertionError(f"gqa {case} {dtype}: the cold kernel with no "
                                             "flag differs from the hot one")
                print(f"[gqa] {case} {dtype} (E, LP, rows a unit, units a page, units a "
                      f"warp: {gqa_geometry(hd, page, n)}): hot and cold (p_cold 0/0.5/1) "
                      f"match, deterministic, every row == the slot alone; max scaled "
                      f"{max(worst):.3e}")
        torch.cuda.synchronize()
    if args.quick:
        return
    for name, (kern, plain, a, nbytes) in gqa_timed_cases(torch, cs).items():
        ms = cs.time_cold(torch, lambda: kern(*a))
        pl = cs.time_cold(torch, lambda: plain(*a))
        bt, sl = (a[7], a[8]) if name.startswith("cold") else (a[3], a[4])
        print(f"[time] {kern.__name__} {name} (lens {sl.tolist()}, table {bt.shape[1]}, hd "
              f"{a[0].shape[-1]}): kernel {ms:.4f} ms, plain {pl:.4f}, bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} (bytes)")


def mlstm_mode(torch, cs, args):
    from repro_torch.kernels.mlstm_chunk import CHUNK, mlstm_chunk
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref
    from repro_torch.kernels.testing import MLSTM_PROFILES, compare_kernel, mlstm_inputs

    if not args.time_only:
        for B, S, dh in ((1, 1, 32), (4, 37, 32), (4, 160, 1024), (1, 256, 1024),
                         (1, 257, 1024), (2, 300, 64), (1, 1000, 1024), (4, 64, 96)):
            for profile in MLSTM_PROFILES:
                for with_state in (False, True):
                    q, k, v, i, f, st = mlstm_inputs(B, S, dh, profile, seed=S, device="cuda",
                                                     with_state=with_state)
                    y, got = mlstm_chunk(q, k, v, i, f, st)
                    y2, got2 = mlstm_chunk(q, k, v, i, f, st)
                    yr, ref = mlstm_chunk_ref(q, k, v, i, f, st, chunk=CHUNK, ragged=True)
                    worst = 0.0
                    for name, g, g2, r in zip(("y", "C", "n", "m"), (y, *got), (y2, *got2),
                                              (yr, *ref)):
                        e = compare_kernel(lambda: g, lambda: r, (), dtype=torch.float32,
                                           label=f"mlstm {name} {(B, S, dh)} {profile} "
                                                 f"state={with_state}")
                        worst = max(worst, e.max_scaled)
                        if not torch.equal(g, g2):
                            raise AssertionError(f"mlstm {name} {(B, S, dh)}: two calls differ")
                    digest = hashlib.sha256()
                    for t in (y, *got):
                        digest.update(t.cpu().numpy().tobytes())
                    print(f"[mlstm] {(B, S, dh)} {profile} state={with_state}: match, "
                          f"deterministic; max scaled {worst:.3e}; bits {digest.hexdigest()[:16]}")
        torch.cuda.synchronize()
    if args.quick:
        return
    for with_state in (False, True):
        q, k, v, i, f, st = mlstm_inputs(4, 160, 1024, "unit", seed=cs.SEED + 11, device="cuda",
                                         with_state=with_state)
        ms = cs.time_cold(torch, lambda: mlstm_chunk(q, k, v, i, f, st))
        pl = cs.time_cold(torch, lambda: mlstm_chunk_ref(q, k, v, i, f, st, chunk=CHUNK,
                                                         ragged=True))
        print(f"[time] mlstm_chunk (4, 160, 1024) state={with_state}: kernel {ms:.4f} ms, "
              f"plain {pl:.4f}")
        if args.split:
            profile_split(torch, cs, lambda: mlstm_chunk(q, k, v, i, f, st))


# the six launches of the mLSTM backward, by a piece of their kernels' names
MLSTM_BWD_LAUNCHES = ("mlstm_state", "bwd_scores", "bwd_rows", "bwd_dstate", "bwd_inputs",
                      "bwd_gates")


def mma_floors(torch, cs):
    """Build ``tools/mma_floors.cu`` and print each tensor-core path's rate
    on a full card: mma.sync in tf32, wgmma in tf32, mma.sync in fp64 (three
    shapes)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.spectral_matmul import _sm_count

    src = ROOT / "tools" / "mma_floors.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = build.BUILD_DIR / "probe" / f"libmma_floors_{digest}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.floor_mma.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    st = torch.cuda.current_stream().cuda_stream
    blocks, iters = 2 * _sm_count(0), 2048
    sink = torch.empty(blocks * 256, device="cuda")
    # flops of one call: 8 warps x 16 m16n8k8, 2 warpgroups x 4 m64n128k8,
    # 8 warps x 8 m8n8k4, each an iteration
    work = {"mma.sync tf32": (0, 8 * 16 * 16 * 8 * 8 * 2),
            "wgmma tf32": (1, 2 * 4 * 64 * 128 * 8 * 2),
            "mma.sync fp64 m8n8k4": (2, 8 * 8 * 8 * 8 * 4 * 2),
            "mma.sync fp64 m16n8k8": (3, 8 * 8 * 16 * 8 * 8 * 2),
            "mma.sync fp64 m16n8k16": (4, 8 * 8 * 16 * 8 * 16 * 2)}
    for name, (kind, flops) in work.items():
        ms = cs.time_cold(torch, lambda: lib.floor_mma(sink.data_ptr(), kind, blocks, iters, st))
        print(f"[floor] {name}: {blocks * iters * flops / ms / 1e9:.1f} TFLOP/s ({ms:.4f} ms, "
              f"{blocks} x 256 threads)")


def mlstm_bwd_vs_fp64(torch, cs):
    """At phase K's worst case and one at xlstm's head width: each gradient's
    largest error over its RMS, of the kernel and of the plain version in
    fp32, against the plain version evaluated in fp64 (a gradient whose fp32
    plain version is itself that far from fp64 cannot be held closer)."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_bwd_cuda
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_bwd_ref
    from repro_torch.kernels.testing import mlstm_inputs

    def f64(t):
        return None if t is None else t.double()

    for B, S, dh, profile, with_state, finals in ((8, 4096, 32, "unit", True, False),
                                                  (1, 300, 1024, "unit", True, True)):
        q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=cs.SEED + S, device="cuda",
                                            with_state=with_state)
        y, fin = mlstm_chunk(q, k, v, i, f, state)
        dy, dfin = cs.mlstm_bwd_cotangents(torch, y, fin, finals, cs.SEED + S)
        a = (q, k, v, i, f, state, y, dy, *dfin)
        got, ref = mlstm_chunk_bwd_cuda(*a), mlstm_chunk_bwd_ref(*a)
        exact = mlstm_chunk_bwd_ref(*(f64(t) for t in a[:5]),
                                    tuple(f64(t) for t in state) if state else None,
                                    *(f64(t) for t in a[6:]))
        for name, g, r, x in zip(("dq", "dk", "dv", "di", "df"), got, ref, exact):
            rms = float(r.pow(2).mean().sqrt())
            print(f"[fp64] {(B, S, dh)} {profile} state={with_state} dstate={finals} {name}: "
                  f"kernel {float((g.double() - x).abs().max()) / rms:.3e}, plain fp32 "
                  f"{float((r.double() - x).abs().max()) / rms:.3e}, kernel vs plain "
                  f"{float((g - r).abs().max()) / rms:.3e} (of the RMS)")
        del q, k, v, i, f, state, y, fin, got, ref, exact
        torch.cuda.empty_cache()


def mlstm_bwd_mode(torch, cs, args):
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_bwd_cuda
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_bwd_ref
    from repro_torch.kernels.testing import (MLSTM_PROFILES, mlstm_bwd_reordered, mlstm_inputs,
                                             tolerance_for)

    rung = tolerance_for(torch.float32)
    names = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
    cases = ([(B, S, 32) for B in (1, 4) for S in (1, 37, 256, 300)]
             + [(2, 160, 1024), (1, 300, 1024), (1, 1000, 1024), (8, 4096, 1024)])
    for B, S, dh in cases if not args.time_only else ():
        for profile in MLSTM_PROFILES:
            for with_state in (False, True):
                q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=S, device="cuda",
                                                    with_state=with_state)
                y, fin = mlstm_chunk(q, k, v, i, f, state)
                for finals in (False, True):
                    dy, dfin = cs.mlstm_bwd_cotangents(torch, y, fin, finals, S)
                    a = (q, k, v, i, f, state, y, dy, *dfin)
                    g1, g2 = mlstm_chunk_bwd_cuda(*a), mlstm_chunk_bwd_cuda(*a)
                    got = list(g1[:5]) + (list(g1[5]) if with_state else [])
                    again = list(g2[:5]) + (list(g2[5]) if with_state else [])
                    if not all(torch.equal(x, z) for x, z in zip(got, again)):
                        raise AssertionError(f"mlstm_bwd {(B, S, dh)}: two calls differ")
                    r = mlstm_chunk_bwd_ref(*a)
                    ref = list(r[:5]) + (list(r[5]) if with_state else [])
                    alt = mlstm_bwd_reordered(*a)
                    worst, which = 0.0, ""
                    for name, g, rr, al in zip(names, got, ref, alt):
                        _, scaled, _ = cs.check_noise_scaled(
                            torch, g, rr, al, rung, f"mlstm_bwd {name} {(B, S, dh)} {profile} "
                            f"state={with_state} dstate={finals}")
                        if scaled > worst:
                            worst, which = scaled, name
                    print(f"[mlstm_bwd] {(B, S, dh)} {profile} state={with_state} "
                          f"dstate={finals}: match, deterministic; max scaled {worst:.3e} "
                          f"({which})")
                    del g1, g2, got, again, r, ref, alt
                del q, k, v, i, f, state, y, fin
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        mlstm_bwd_vs_fp64(torch, cs)
    if args.quick:
        return
    from torch.profiler import ProfilerActivity, profile

    mma_floors(torch, cs)
    q, k, v, i, f, _ = mlstm_inputs(8, 4096, 1024, "unit", seed=cs.SEED + 12, device="cuda")
    y, _ = mlstm_chunk(q, k, v, i, f)
    dy = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 13),
                     device="cuda")
    a = (q, k, v, i, f, None, y, dy, None, None, None)
    ms = cs.time_cold(torch, lambda: mlstm_chunk_bwd_cuda(*a), iters=20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            mlstm_chunk_bwd_cuda(*a)
        torch.cuda.synchronize()
    rows = dict.fromkeys(MLSTM_BWD_LAUNCHES, 0.0)
    for t, _, key in cs.device_rows(torch, prof):
        for name in MLSTM_BWD_LAUNCHES:
            if name in key:
                rows[name] += t / 5
    flops, nbytes = cs.mlstm_train_work(8, 4096, 1024, backward=True)
    print(f"[time] mlstm_chunk_bwd (8, 4096, 1024), empty state, no final gradient: call "
          f"{ms:.4f} ms cold L2; a launch " + ", ".join(f"{n} {t:.4f}" for n, t in rows.items())
          + f"; bound {flops / cs.PEAK_FLOPS['float32'] * 1e3:.4f} (fp32), "
          f"{cs.mlstm_bwd_bound_tc(8, 4096, 1024) * 1e3:.4f} (3xTF32 and fp64 tensor cores)")


def mamba_view(torch, u, dt, B, C, A, D, dt_rank=256):
    """The model's layout of the scan's inputs: B and C column views of one
    (b, S, dt_rank + 2 ds) projection (``nn/mamba.py:_mamba_ssm_params``),
    A and D in u's dtype. (``kernels/testing.py:mamba_model_layout`` does
    the same, but a tree probed with ``--src`` may predate it.)"""
    b, S, ds = B.shape
    proj = torch.randn((b, S, dt_rank + 2 * ds), device=u.device).to(u.dtype)
    proj[..., dt_rank:dt_rank + ds] = B
    proj[..., dt_rank + ds:] = C
    return (u, dt, proj[..., dt_rank:dt_rank + ds], proj[..., dt_rank + ds:], A.to(u.dtype),
            D.to(u.dtype))


def mamba_floors(torch, cs, shapes):
    """Build ``tools/mamba_floors.cu`` and time its floors at each (S, di,
    ds) of ``shapes`` (b 1, bf16)."""
    import ctypes
    import hashlib

    from repro_torch.kernels import build
    from repro_torch.kernels.spectral_matmul import _sm_count
    from repro_torch.kernels.testing import mamba_inputs

    src = ROOT / "tools" / "mamba_floors.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = build.BUILD_DIR / "probe" / f"libmamba_floors_{digest}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.floor_empty.argtypes = [i, i, i, p]
    lib.floor_one_round.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.floor_exps.argtypes = [p, i, i, i, i, p]
    st = torch.cuda.current_stream().cuda_stream
    sms = _sm_count(0)
    blocks, threads = sms * 16, 128                 # 2048 threads an SM: a full card
    sink = torch.empty(blocks * threads + (1 << 22), device="cuda")
    for S, di, ds in shapes:
        u, dt, B, C, _, _ = mamba_inputs(1, S, di, ds, "unit", dtype=torch.bfloat16,
                                         seed=cs.SEED + 12, device="cuda")
        grid = -(-di // 32)
        t_empty = cs.time_cold(torch, lambda: lib.floor_empty(grid, 1, 128, st))
        t_round = cs.time_cold(torch, lambda: lib.floor_one_round(
            u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), sink.data_ptr(), 1, S, di,
            ds, st))
        n = -(-S * di * ds // (4 * blocks * threads))
        t_exp = [cs.time_cold(torch, lambda: lib.floor_exps(sink.data_ptr(), blocks, threads, n,
                                                            mode, st)) for mode in (0, 1, 2)]
        print(f"[floor] S {S}, di {di}, ds {ds}: empty kernel ({grid} x 128) {t_empty:.4f} ms, "
              f"one round of loads {t_round:.4f}; {4 * n * blocks * threads} exponentials of "
              f"dt * a on {blocks} x {threads}: expf {t_exp[0]:.4f}, exp2f {t_exp[1]:.4f}, "
              f"ex2.approx {t_exp[2]:.4f}")


def mamba_mode(torch, cs, args):
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.mamba_ref import mamba_scan_ref
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_cuda
    from repro_torch.kernels.testing import MAMBA_PROFILES, compare_kernel, mamba_inputs

    bf = torch.bfloat16
    if not args.time_only:
        from repro_torch.kernels.mamba_scan import scan_plan

        cases = [(1, 1, 128, 16), (2, 37, 200, 16), (1, 160, 8192, 16), (2, 300, 96, 4),
                 (1, 64, 130, 64), (2, 1000, 256, 8), (1, 33, 64, 32), (1, 4096, 8192, 16)]
        for b, S, di, ds in cases:
            worst = 0.0
            for dtype in (torch.float32, bf):
                for profile in MAMBA_PROFILES:
                    base = mamba_inputs(b, S, di, ds, profile, dtype=dtype, seed=S,
                                        device="cuda")
                    for layout, a in (("contiguous", base),
                                      ("model", mamba_view(torch, *base))):
                        before = LAUNCHES["mamba_scan"]
                        y, h = mamba_scan(*a)
                        y2, h2 = mamba_scan(*a)
                        if LAUNCHES["mamba_scan"] != before + 2:
                            raise AssertionError("mamba_scan: launches not counted once a call")
                        if not (torch.equal(y, y2) and torch.equal(h, h2)):
                            raise AssertionError(f"mamba {(b, S, di, ds)}: two calls differ")
                        yr, hr = mamba_scan_ref(*a)
                        for name, g, r in (("y", y, yr), ("hT", h, hr)):
                            e = compare_kernel(lambda: g, lambda: r, (), dtype=torch.float32,
                                               label=f"mamba {name} {(b, S, di, ds)} {dtype} "
                                                     f"{profile} {layout}")
                            worst = max(worst, e.max_scaled)
            work = cs.kernels_a_call(torch, lambda: mamba_scan(*a))
            if work != {"kernel": 1}:
                raise AssertionError(f"mamba {(b, S, di, ds)}: {work} a call on the model's "
                                     "layout, not one kernel")
            print(f"[mamba] {(b, S, di, ds)} plan {scan_plan(b, S, di, ds)}: fp32 and bf16, "
                  f"both profiles, contiguous and the model's layout match at the fp32 rung, "
                  f"deterministic, one device kernel a call; max scaled {worst:.3e}")
        torch.cuda.synchronize()
    if args.quick:
        return
    for S in (cs.MLSTM_PREFILL_S, 4096):
        base = mamba_inputs(1, S, 8192, 16, "unit", dtype=bf, seed=cs.SEED + 12, device="cuda")
        u, dt, B, C, A, D = base
        model = mamba_view(torch, *base)
        Af, Df = model[4].float(), model[5].float()
        alone = cs.time_cold(torch, lambda: mamba_scan_cuda(u, dt, B, C, Af, Df))
        op = cs.time_cold(torch, lambda: mamba_scan(*model))
        # (the plain version's 4096-step host loop outlasts time_cold's spin)
        plain = (f"{cs.time_cold(torch, lambda: mamba_scan_ref(*model)):.4f}" if S < 1000
                 else "not timed")
        nbytes = 2 * (3 * S * 8192 + 2 * S * 16 + 8192 * 16 + 8192) + 4 * 8192 * 16
        work = cs.kernels_a_call(torch, lambda: mamba_scan(*model))
        print(f"[time] mamba_scan (1, {S}, 8192, 16) bf16: kernel alone {alone:.4f} ms, op on "
              f"the model's layout {op:.4f} ({work} a call), plain {plain}, "
              f"bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} (bytes)")
    # how often a profile of the scan comes back empty
    base = mamba_inputs(1, cs.MLSTM_PREFILL_S, 8192, 16, "unit", dtype=bf, seed=cs.SEED + 12,
                        device="cuda")
    model = mamba_view(torch, *base)
    counts = [profiled_kernels(torch, cs, lambda: mamba_scan(*model)) for _ in range(20)]
    print(f"[profile] kernel records of 5 scan calls in each of 20 profiles: {counts}")
    mamba_floors(torch, cs, ((cs.MLSTM_PREFILL_S, 8192, 16), (4096, 8192, 16)))


def bits_digest(torch, *tensors) -> str:
    """A short digest of the tensors' bits (to hold two trees' bits equal)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mamba_bwd_mode(torch, cs, args):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.mamba_ref import mamba_scan_bwd_ref
    from repro_torch.kernels.mamba_scan import STATE_WIDTHS, mamba_scan_bwd_cuda, mamba_scan_cuda
    from repro_torch.kernels.testing import (MAMBA_PROFILES, mamba_inputs, mamba_model_layout,
                                             tolerance_for)

    occ = getattr(build.library(), "sct_mamba_scan_bwd_occupancy", None)
    if occ is None:
        print("[occupancy] this tree's library does not export the walk's occupancy")
    else:
        from repro_torch.kernels.mamba_scan import BWD_STATES, bwd_plan

        for ds in STATE_WIDTHS:
            for code, name, size in ((1, "bf16", 2), (0, "fp32", 4)):
                p = bwd_plan(1, 1, 32, ds, size)
                print(f"[occupancy] d_state {ds} {name}: {occ(ds, BWD_STATES[ds], code)} walk "
                      f"blocks an SM ({p.threads} threads, {p.smem_bytes} bytes of shared "
                      f"memory; launch bounds ask {p.min_blocks})")
    rung = tolerance_for(torch.float32)
    names = ("du", "ddt", "dB", "dC", "dA", "dD")
    cases = [(1, 1, 128, 16), (2, 37, 200, 16), (1, 160, 8192, 16), (2, 300, 96, 4),
             (1, 64, 130, 64), (2, 1000, 256, 8), (1, 33, 64, 32), (2, 4096, 8192, 16)]
    exact = total = 0
    for b, S, di, ds in cases if not args.time_only else ():
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for profile_ in MAMBA_PROFILES:
                a = mamba_inputs(b, S, di, ds, profile_, dtype=dtype, seed=S, device="cuda")
                y, h, hs = mamba_scan_cuda(*a, record=True)
                gen = torch.Generator(device="cuda").manual_seed(S + 1)
                dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
                dh = torch.randn(h.shape, generator=gen, device="cuda")
                for fin in (None, dh):
                    before = LAUNCHES["mamba_scan_bwd"]
                    got = mamba_scan_bwd_cuda(*a, hs, dy, fin)
                    again = mamba_scan_bwd_cuda(*a, hs, dy, fin)
                    if LAUNCHES["mamba_scan_bwd"] != before + 2:
                        raise AssertionError("mamba_scan_bwd: not counted once a call")
                    if not all(torch.equal(g, x) for g, x in zip(got, again)):
                        raise AssertionError(f"mamba_scan_bwd {(b, S, di, ds)}: two calls differ")
                    ref = mamba_scan_bwd_ref(*a, hs, dy, fin)
                    for name, g, r in zip(names, got, ref):
                        _, _, scaled = cs.check_noise_scaled(
                            torch, g, r, r, rung, f"mamba_scan_bwd {name} {(b, S, di, ds)} "
                            f"{dtype} {profile_} dhT={fin is not None}")
                        worst = max(worst, scaled)
                    exact += all(torch.equal(g, r) for g, r in zip(got, ref))
                    total += 1
                    del got, again, ref
                del a, y, h, hs, dy, dh
            torch.cuda.empty_cache()
        print(f"[mamba_bwd] {(b, S, di, ds)}: fp32 and bf16, both profiles, with and without "
              f"dhT: fp32 rung, deterministic; max RMS-scaled error {worst:.3e}")
    if total:
        print(f"[mamba_bwd] {exact} of {total} cases bit for bit the plain version")
    # the bits of #8 (serving's prompt, recording or not) and #8b at the
    # training shape on the model's layout, to compare two trees
    for b, S in ((1, cs.MLSTM_PREFILL_S), (2, 4096)):
        a = mamba_model_layout(*mamba_inputs(b, S, 8192, 16, "unit", dtype=torch.bfloat16,
                                             seed=cs.SEED + 17, device="cuda"), dt_rank=256)
        y0, h0 = mamba_scan_cuda(*a)
        y, h, hs = mamba_scan_cuda(*a, record=True)
        dy = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(
            cs.SEED + 18), device="cuda").to(y.dtype)
        grads = mamba_scan_bwd_cuda(*a, hs, dy)
        print(f"[digest] (b {b}, S {S}, di 8192, d_state 16, bf16, model layout): #8 "
              f"{bits_digest(torch, y0, h0)}, #8 recording {bits_digest(torch, y, h, hs)}, #8b "
              f"{bits_digest(torch, *grads)}")
        del a, y0, h0, y, h, hs, dy, grads
    torch.cuda.empty_cache()
    if args.quick:
        return
    b, S, di, ds = 2, 4096, 8192, 16
    a = mamba_model_layout(*mamba_inputs(b, S, di, ds, "unit", dtype=torch.bfloat16,
                                         seed=cs.SEED + 17, device="cuda"), dt_rank=256)
    _, _, hs = mamba_scan_cuda(*a, record=True)
    dy = torch.randn((b, S, di), generator=torch.Generator(device="cuda").manual_seed(
        cs.SEED + 18), device="cuda").to(torch.bfloat16)
    ms = cs.time_cold(torch, lambda: mamba_scan_bwd_cuda(*a, hs, dy), iters=20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            mamba_scan_bwd_cuda(*a, hs, dy)
        torch.cuda.synchronize()
    rows = {"walk": 0.0, "reduce": 0.0}
    for t, _, key in cs.device_rows(torch, prof):
        if "mamba_scan_bwd" in key:
            rows["reduce" if "reduce" in key else "walk"] += t / 5
    flops = b * S * di * (18 * ds + 6) - 2 * b * S * ds
    print(f"[time] mamba_scan_bwd {(b, S, di, ds)} bf16, model layout, no dhT: call {ms:.4f} ms "
          f"cold L2; walk {rows['walk']:.4f}, reduce {rows['reduce']:.4f} (profiled, L2 "
          f"flushed); bound {flops / cs.PEAK_FLOPS['float32'] * 1e3:.4f} (fp32 at 67 TFLOP/s), "
          f"{flops / (132 * 128 * cs.SM_CLOCK_HZ) * 1e3:.4f} (unfused: an operation a "
          f"lane-clock)")


def profiled_kernels(torch, cs, fn, calls: int = 5) -> int:
    """The device kernel records of one profile of ``calls`` calls of
    ``fn()`` (the profiler drops some now and then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(n for _, n, _ in cs.device_rows(torch, prof))


def q8_checks(torch, cs, gen, spectral_matmul_q8):
    """The int8 kernel's launch geometry, its outputs against the plain
    version and the batch invariance of its rows, in bf16."""
    from repro_torch.kernels.spectral_matmul import _sm_count, kernel_geometry
    from repro_torch.kernels.testing import SCALE_PROFILES, SPECTRAL_Q8_SHAPES, compare_kernel

    bf = torch.bfloat16
    sms = _sm_count(0)
    for M in (4, 64, 256, 8192):
        for m, n in MLP_SHAPES:
            rows, split, cl, bn = kernel_geometry(M, m, n, bf, sms)
            width = cl if split else 1
            cols = -(-n // bn)
            blocks = -(-M // rows) * (-(-cols // width) * width)
            mslice = -(-(-(-m // cl)) // 64) * 64
            stages = (mslice if split else cl * mslice) // 64
            print(f"[q8] geometry ({M}, {m}->{n}): rows {rows}, cluster {cl} "
                  f"({'split' if split else 'one block'}), bn {bn}, {blocks} blocks, "
                  f"{stages} x-U stages and {-(-bn // 64)} V tiles a block")
    for shape in SPECTRAL_Q8_SHAPES:
        for profile in SCALE_PROFILES:
            a = cs.q8_inputs(torch, *shape, profile, bf, gen)
            e = compare_kernel(spectral_matmul_q8, cs.q8_plain, a,
                               label=f"q8 {shape} {profile}")
        print(f"[q8] {shape}: matches over {list(SCALE_PROFILES)} (last: max abs "
              f"{e.max_abs:.3e}, scaled {e.max_scaled:.3e})")
    for m, n in MLP_SHAPES:
        for profile in SCALE_PROFILES:
            x, U, s, V = cs.q8_inputs(torch, 256, m, n, RANK, profile, bf, gen)
            for M in (1, 4, 37, 64, 160, 256):
                full = spectral_matmul_q8(x[:M], U, s, V)
                for i in range(M):
                    if not torch.equal(spectral_matmul_q8(x[i:i + 1], U, s, V)[0], full[i]):
                        raise AssertionError(f"q8 {m}->{n} {profile}: row {i} of M={M} "
                                             "differs from the row alone")
        print(f"[q8] {m}->{n}: every row of M in 1/4/37/64/160/256 == alone, "
              f"every scale profile")
    torch.cuda.synchronize()


def q8_mode(torch, cs, gen, args):
    from repro_torch.core.spectral import spectral_apply
    from repro_torch.kernels.ops import spectral_matmul, spectral_matmul_q8
    from repro_torch.kernels.ref import spectral_matmul_q8_ref
    from repro_torch.kernels.spectral_matmul_q8 import spectral_matmul_q8_cuda
    from repro_torch.serving.quantize import dequantize_int8

    bf = torch.bfloat16
    if not args.time_only:
        q8_checks(torch, cs, gen, spectral_matmul_q8)
    if args.quick:
        return
    for M, what in ((4, "decode layer (3 launches, M 4)"),
                    (64, "prefill chunk's layer (3 launches, M 64)")):
        tot = [0.0] * 5
        for m, n in (MLP_SHAPES[0], MLP_SHAPES[0], MLP_SHAPES[1]):
            x, U, s, V = cs.q8_inputs(torch, M, m, n, RANK, "unit", bf, gen)
            Ub, Vb = dequantize_int8(U, bf), dequantize_int8(V, bf)
            fac = {"U": Ub, "s": s, "V": Vb}
            gain = U["scale"] * s * V["scale"]
            t = (cs.time_cold(torch, lambda: spectral_matmul_q8_cuda(x, U["q8"], gain, V["q8"])),
                 cs.time_cold(torch, lambda: spectral_matmul_q8_ref(x, U["q8"], gain, V["q8"])),
                 cs.time_cold(torch, lambda: spectral_apply(fac, x)),
                 cs.time_cold(torch, lambda: spectral_matmul(x, Ub, s, Vb)),
                 (2 * M * (m + n) + RANK * (m + n) + 12 * RANK) / cs.HBM_BYTES_PER_S * 1e3)
            tot = [a + c for a, c in zip(tot, t)]
            print(f"[time] spectral_matmul_q8 ({M}, {m}->{n}): kernel {t[0]:.4f} ms, "
                  f"bf16 kernel {t[3]:.4f}, chain {t[2]:.4f}")
        print(f"[time] spectral_matmul_q8 {what}: kernel {tot[0]:.4f} ms, plain {tot[1]:.4f}, "
              f"chain {tot[2]:.4f}, bf16 kernel {tot[3]:.4f}, bound {tot[4]:.4f} (bytes)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd", action="store_true", help="the flash forward")
    ap.add_argument("--q8", action="store_true", help="the int8 spectral matmul in bf16")
    ap.add_argument("--mla", action="store_true", help="the absorbed-MLA decode")
    ap.add_argument("--mlstm", action="store_true", help="the chunkwise mLSTM")
    ap.add_argument("--mlstm-bwd", action="store_true", help="the chunkwise mLSTM's backward")
    ap.add_argument("--gqa", action="store_true", help="the paged GQA decode")
    ap.add_argument("--mamba", action="store_true", help="the selective scan")
    ap.add_argument("--mamba-bwd", action="store_true", help="the selective scan's backward")
    ap.add_argument("--quick", action="store_true", help="checks only")
    ap.add_argument("--time-only", action="store_true", help="timing only")
    ap.add_argument("--split", action="store_true",
                    help="also time phase-isolating shapes and each backward kernel")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose port is probed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.core.spectral import spectral_apply
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref
    from repro_torch.kernels.ops import spectral_matmul
    from repro_torch.kernels.ref import spectral_matmul_ref
    from repro_torch.kernels.testing import compare_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi())
    print(f"[probe] port from {Path(build.__file__).resolve().parents[2]}")
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    if args.gqa:
        print_ptxas(build, ("paged_decode.cu",))
        gqa_mode(torch, cs, args)
        return 0
    if args.mamba:
        print_ptxas(build, ("mamba_scan.cu",))
        mamba_mode(torch, cs, args)
        return 0
    if args.mamba_bwd:
        print_ptxas(build, ("mamba_scan_bwd.cu",))
        mamba_bwd_mode(torch, cs, args)
        return 0
    if args.mlstm_bwd:
        print_ptxas(build, ("mlstm_chunk_bwd.cu",))
        mlstm_bwd_mode(torch, cs, args)
        return 0
    if args.mla or args.mlstm:
        if args.mla:
            print_ptxas(build, ("paged_mla_decode.cu",))
            mla_mode(torch, cs, args)
        if args.mlstm:
            print_ptxas(build, ("mlstm_chunk.cu",))
            mlstm_mode(torch, cs, args)
        return 0
    if args.fwd or args.q8:
        if args.fwd:
            print_ptxas(build, ("flash_attention.cu",), only="flash_fwd")
            fwd_mode(torch, cs, gen, args)
        if args.q8:
            print_ptxas(build, ("spectral_matmul_tc.cu",))
            q8_mode(torch, cs, gen, args)
        return 0
    print_ptxas(build, ("spectral_matmul_tc.cu", "flash_attention.cu"))

    # ---- spectral: correctness, invariance ----
    shapes = [(4, 2048, 8192, 128), (4, 8192, 2048, 128), (64, 2048, 8192, 128),
              (160, 2730, 2048, 128), (4, 4096, 14336, 256), (160, 14336, 4096, 256),
              (8192, 2048, 8192, 128), (8192, 8192, 2048, 128), (37, 300, 700, 64)]
    for M, m, n, k in shapes if not args.time_only else ():
        a = cs.spectral_inputs(torch, M, m, n, k, bf, gen)
        e = compare_kernel(spectral_matmul, spectral_matmul_ref, a,
                           label=f"spectral {M}x{m}->{n} r{k}")
        print(f"[spectral] {M}x{m}->{n} rank {k}: max abs {e.max_abs:.3e}, "
              f"scaled {e.max_scaled:.3e}")
    for m, n, k in ((2048, 8192, 128), (8192, 2048, 128), (2048, 8192, 256)) \
            if not args.time_only else ():
        x, U, s, V = cs.spectral_inputs(torch, 8192, m, n, k, bf, gen)
        for M in (1, 4, 37, 64, 160, 8192):
            full = spectral_matmul(x[:M], U, s, V)
            for i in sorted({0, M // 2, M - 1}):
                if not torch.equal(spectral_matmul(x[i:i + 1], U, s, V)[0], full[i]):
                    raise AssertionError(f"spectral {m}->{n} r{k}: row {i} of M={M} "
                                         "differs from the row alone")
        print(f"[spectral] {m}->{n} rank {k}: rows of M in 1/4/37/64/160/8192 == alone")

    # ---- flash backward: correctness, determinism ----
    for case in ((1, 4096, 8, 4, 64), (1, 1000, 4, 4, 64), (2, 4096, 32, 1, 64),
                 (2, 256, 2, 2, 128), (1, 300, 1, 3, 64)) if not args.time_only else ():
        q, kk, v, do = cs.flash_inputs(torch, *case, bf, gen)
        out, mm, ll = flash_fwd_ref(q, kk, v)
        got = flash_attention_bwd(q, kk, v, out, mm, ll, do)
        again = flash_attention_bwd(q, kk, v, out, mm, ll, do)
        ref = flash_bwd_ref(q, kk, v, out, mm, ll, do)
        for name, g1, g2, r1 in zip(("dq", "dk", "dv"), got, again, ref):
            e = compare_kernel(lambda: g1, lambda: r1, (), label=f"flash bwd {name} {case}")
            if not torch.equal(g1, g2):
                raise AssertionError(f"flash bwd {name} {case}: two calls differ")
            print(f"[flash_bwd] {case} {name}: max abs {e.max_abs:.3e}, scaled "
                  f"{e.max_scaled:.3e}, deterministic")
        del q, kk, v, do, out, mm, ll, got, again, ref
    torch.cuda.synchronize()
    if args.quick:
        print("quick: checks passed")
        return 0

    # ---- timing ----
    def spectral_times(M, m, n, k):
        x, U, s, V = cs.spectral_inputs(torch, M, m, n, k, bf, gen)
        fac = {"U": U, "s": s, "V": V}
        t = (cs.time_cold(torch, lambda: spectral_matmul(x, U, s, V)),
             cs.time_cold(torch, lambda: spectral_matmul_ref(x, U, s, V)),
             cs.time_cold(torch, lambda: spectral_apply(fac, x)))
        bound = max(2 * (M * m + m * k + n * k + M * n) / cs.HBM_BYTES_PER_S,
                    2 * M * k * (m + n) / cs.PEAK_FLOPS["bfloat16"]) * 1e3
        return t + (bound,)

    rows = {}
    dec = [spectral_times(4, 2048, 8192, 128), spectral_times(4, 2048, 8192, 128),
           spectral_times(4, 8192, 2048, 128)]
    rows["decode layer (3 launches, M 4)"] = tuple(sum(t[i] for t in dec) for i in range(4))
    rows["prefill chunk (64, 2048->8192)"] = spectral_times(64, 2048, 8192, 128)
    rows["training up (8192, 2048->8192)"] = spectral_times(8192, 2048, 8192, 128)
    rows["training down (8192, 8192->2048)"] = spectral_times(8192, 8192, 2048, 128)
    for name, (ms, plain, lib, bound) in rows.items():
        print(f"[time] spectral_matmul {name}: kernel {ms:.4f} ms, plain {plain:.4f}, "
              f"chain {lib:.4f}, bound {bound:.4f}")

    b, s_, h, d = 2, 4096, 32, 64
    q, kk, v, do = cs.flash_inputs(torch, b, s_, h, 1, d, bf, gen)
    out, mm, ll = flash_fwd_ref(q, kk, v)
    ms = cs.time_cold(torch, lambda: flash_attention_bwd(q, kk, v, out, mm, ll, do))

    def heads(t):
        return t.reshape(b, s_, h, d).transpose(1, 2).contiguous()

    qg, kg, vg = (heads(t).detach().requires_grad_() for t in (q, kk[:, :, :, None],
                                                                v[:, :, :, None]))
    oh = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib = cs.time_cold(torch, lambda: torch.autograd.grad(oh, (qg, kg, vg), heads(do),
                                                           retain_graph=True))
    flops = 2.5 * 2 * 2 * b * h * s_ * s_ * d / 2
    print(f"[time] flash_attention_bwd (2, 4096, 32 heads, d 64): kernel {ms:.4f} ms, "
          f"SDPA backward {lib:.4f}, bound {flops / cs.PEAK_FLOPS['bfloat16'] * 1e3:.4f}")
    if args.split:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_attention_bwd(q, kk, v, out, mm, ll, do)
            torch.cuda.synchronize()
        for ms_all, count, key in cs.device_rows(torch, prof)[:4]:
            print(f"[split] {key[:70]}: {ms_all / count:.4f} ms a launch, {count} launches")
        # the spectral kernel's phases, isolated by shape: a 256-wide m
        # (one block, no cluster) leaves phase 2; a 256-wide n leaves phase 1
        for M, m, n in ((8192, 256, 8192), (8192, 2048, 256), (8192, 8192, 256),
                        (8192, 256, 2048)):
            t = spectral_times(M, m, n, 128)
            print(f"[split] spectral ({M}, {m}->{n}): kernel {t[0]:.4f} ms, chain {t[2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
