#!/usr/bin/env python3
"""Where a kernel's time goes, by ablation, on one GPU: the bf16 flash
backward (or forward), the absorbed-MLA or GQA paged decode, or the
chunkwise mLSTM or its backward, or the selective scan.

    python3 tools/flash_bwd_ablate.py [--fwd | --mla | --gqa | --mlstm | --mlstm-bwd | --mamba
                                       | --mamba-bwd] [--src DIR] [--only NAME,NAME,...]

Copies the port into ``src/repro_torch/_build/ablate/<variant>/`` (git-ignored)
with one part of the two backward kernels (``csrc/flash_attention.cu``,
``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkdv_tc_kernel``) taken out,
builds each copy, and prints each kernel's device time (``torch.profiler``,
five calls) at smollm2-1.7b's training shape (b 2, s 4096, 32 heads, d 64):

- ``base``: the kernels as they are;
- ``no_softmax``: p = S and ds = p dP, no exp, rounding or statistics;
- ``no_products``: no wgmma (the softmax pass reads stale registers);
- ``no_streaming``: no tile is copied after the first (the dQ kernel's
  K/V, the dK/dV kernel's Q/dO and statistics);
- ``no_loop``: the dQ kernel walks no kv tile (its prologue and epilogue);
- ``skeleton``: neither softmax, products nor streaming (the loop alone).

``--fwd`` takes the same parts out of the forward (``flash_fwd_tc_kernel``):
``no_softmax`` (p = S: no exp, rounding or rescale), ``no_products``,
``no_streaming`` (K/V tile 0 only) and ``skeleton``; and ``carveout``,
the kernel as it is with the shared-memory carveout set to its maximum.
It times the forward as one kernel.

``--mla`` takes parts out of the absorbed-MLA decode
(``csrc/paged_mla_decode.cu``, hot and cold: one template) and times
``paged_mla_decode`` and ``paged_mla_decode_cold`` at ``chip_smoke.py``'s
timed shapes (deepseek-v3-671b's width, fp32 q; hot: 4 slots of lengths
40/176/87/128 in 16-page tables; cold: 4 slots of 95 tokens in 8-page
tables, one cold page a slot), cold-L2 medians (``chip_smoke.time_cold``).
It recognises the cluster design (one block a 16-head group and page
rank, combined through distributed shared memory) and the split design
(live pages packed onto 64-head blocks, a second combine pass), and takes
out of either: ``no_combine`` (the cluster design combines and writes
nothing; the split design launches no combine pass), ``no_scores`` (no
q . k products), ``no_softmax`` (no exp), ``no_pv`` (no p . v products),
``no_staging`` (no page row is copied into shared memory) and ``skeleton``
(all five). The cluster design adds ``live_ranks``: the cluster sized to
the fewest live pages of any slot at each shape (6 cold, 3 hot), so that
no rank walks nothing; the split design ``no_q_load`` (q rows zeroed, not
read) and ``direct_out`` (every block writes o_lat as if its slot had one
item: no partial states). ``--src DIR`` ablates another checkout's ``src``
(a ``git archive`` of an earlier tree).

``--gqa`` takes parts out of the paged GQA decode (``csrc/paged_decode.cu``,
hot and cold: one template) and times ``paged_gqa_decode`` and
``paged_gqa_decode_cold`` at ``chip_smoke.py``'s timed shapes (llama3.2-1b:
b 4, kvh 8, rep 4, hd 64, page 16, bf16 q; hot: lengths 40/176/87/128 in
16-page tables; cold: 95 tokens a slot in 8-page tables, one cold page a
slot), cold-L2 medians. Of the cluster design (a rank a page, combined
through distributed shared memory) and of the warp-a-page design (one
block a slot and query head, warps walking the pages) it takes out
``no_combine`` (the outputs are not combined or written), ``no_staging``
(no K/V row is read), ``no_scores``, ``no_softmax``, ``no_pv`` (the
warp-a-page design keeps one product a row, so that the V rows are still
read) and ``skeleton`` (all five); the cluster design adds ``cluster_1`` …
``cluster_8`` (the cluster size fixed), the warp-a-page design ``warps_4``
and ``warps_16`` (warps a block; the base has 8).

``--mlstm`` takes parts out of the chunkwise mLSTM (``csrc/mlstm_chunk.cu``)
and prints each of its three launches' device time (``torch.profiler``,
five calls) and the call's cold-L2 median at the xlstm prefill shape (B 4,
S 160, dh 1024, empty state): ``scores_no_load`` (no q / k stage copied),
``scores_no_fma`` (a quarter of the products), ``state_one_pass`` (the
update's big x big tf32 product alone, of three), ``out_no_stats`` (no
chunk statistics), ``out_no_w`` (no gated scores), ``out_no_gemm`` (no
(w.S) @ v).

``--mlstm-bwd`` takes parts out of the mLSTM backward
(``csrc/mlstm_chunk_bwd.cu``) and prints the call's cold-L2 median and each
of its six launches' device time (``torch.profiler``, five calls, the L2
flushed before each) at xlstm-1.3b's training shape (B 8 = 2 x 4 heads,
S 4096, dh 1024, the empty state, no gradient of the final state):
``no_carried`` (the input gradients' carried-state products dy C0^T,
v dC1^T and k dC1 left out), ``no_triangle`` (their three triangle
products left out), ``no_dc_update`` (the reverse sweep's q dnum^T update
of dC left out), ``scores_fp32`` (the two score products summed in fp32,
not fp64) and ``skeleton`` (all four). Of the tensor-core design (both
products as wgmma stages) it takes out ``no_wgmma`` (no product is
issued), ``no_split`` (no stage is split for the tensor cores),
``no_loads`` (no raw stage is copied after the first two), ``no_flush``
(the partial tiles are not added) and ``skeleton`` (the first three), and
adds ``one_pass`` (big . big alone, of the three tf32 products),
``raw_3`` (three raw stages, the next but one sent for a stage
ahead; the base has four)
and ``near_loads`` (every stage copies the rows of the first 64 depths
again: the same copies, served by the caches).

``--mamba`` takes parts out of the selective scan (``csrc/mamba_scan.cu``)
and times the kernel alone (contiguous B and C, A and D in fp32) at jamba's
prompt (b 1, S 160, di 8192, d_state 16, bf16) and at S 4096, cold-L2
medians. Of the design that walks one step at a time with the lanes' sums
in the chain (4 lanes a channel, 32-step tiles staged by strided loops) it
takes out ``no_staging`` (no tile of u, dt, B or C is loaded), ``no_exp``
(dA = dt a, no exp), ``no_shuffle`` (the lanes' sums are not combined),
``no_writeback`` (no y is stored) and ``skeleton`` (all four), and adds
``empty`` (the kernel returns at once: the same grid, no work). Of the
design that walks groups of steps (loads, then exps, then the chain, then
the lanes' sums) it takes out ``no_staging``, ``no_exp``, ``no_shuffle``,
``no_ywrite`` (no y is written out of shared memory) and ``skeleton``,
and adds ``empty``, ``states_2`` /
``states_8`` (states a thread at d_state 16; the base holds 4), ``steps_1``
(a step at a time in place of groups of 32 / states steps) and ``exp2`` (dA
= exp2f(dt (A log2 e)) in place of the accurate expf(dt A): what the exp's
instruction slots cost).

``--mamba-bwd`` takes parts out of the selective scan's backward
(``csrc/mamba_scan_bwd.cu``) and prints the call's cold-L2 median and the
device time of its two launches, the reverse walk and the reduction of its
partials (``torch.profiler``, five calls, the L2 flushed before each), at
jamba's training shape (b 2, S 4096, di 8192, d_state 16, bf16, the
model's layout, no gradient of the final state). Of the design that
recomputes a stretch into shared memory and walks it a step at a time it
takes out ``no_channel_sums`` (the block's sums of dy h and g du over its
channels, and their partials), ``no_state_sums`` (the trees and shuffles
over a channel's states: each lane stores its first state's products),
``no_staging`` (no u, dt, dy, B or C is loaded into shared memory) and
``no_recompute_stores`` (the recomputed states and exps are not stored:
the walk reads stale shared memory), and ``skeleton`` (all four). Of the
design that keeps a group of the stretch in registers (a forward pass
keeping each group's start, the groups recomputed and walked back, the
sums batched through shared memory) it takes out ``no_channel_sums`` (no
batch is summed over the warp's channels), ``no_state_sums`` (no (step,
channel) adds its lanes' sums or writes du and ddt), ``no_staging`` (no
stretch is copied in), ``no_convert`` (the raw stretch is not converted to
fp32) and ``skeleton`` (all four), and adds ``no_recompute`` (the groups
before the last are not recomputed: their reverse steps read the last
group's exps), ``no_exp`` (e = dt a, no exp), ``no_partials`` (the block
writes no partial of dB and dC), ``min_blocks_3`` (launch bounds of 3
blocks an SM, not 4: more registers), ``reverse_quads`` (the reverse
steps load dt, u and dy four steps at a time, not two) and ``states_2`` /
``states_8`` (states a thread at d_state 16; the base holds 4).

``--only`` builds and times the named variants alone. The variants compute
wrong results: they are timings only. Needs no JAX.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "src/repro_torch/csrc/flash_attention.cu"
MLA_SRC = "src/repro_torch/csrc/paged_mla_decode.cu"
MLSTM_SRC = "src/repro_torch/csrc/mlstm_chunk.cu"
MLSTM_BWD_SRC = "src/repro_torch/csrc/mlstm_chunk_bwd.cu"
GQA_SRC = "src/repro_torch/csrc/paged_decode.cu"
MAMBA_SRC = "src/repro_torch/csrc/mamba_scan.cu"
MAMBA_BWD_SRC = "src/repro_torch/csrc/mamba_scan_bwd.cu"
PLAN_SRC = "src/repro_torch/kernels/mamba_scan.py"
OUT = ROOT / "src" / "repro_torch" / "_build" / "ablate"


def _sub(s: str, a: int, b: int, old: str, new: str) -> str:
    seg = s[a:b]
    if old not in seg:
        raise SystemExit(f"ablate: {old[:60]!r} not found; the kernel source changed")
    return s[:a] + seg.replace(old, new) + s[b:]


def variants(src: str) -> dict:
    """{name: patched flash_attention.cu}."""
    dq_a = src.index("flash_bwd_dq_tc_kernel(const bf16*")
    kv_a = src.index("struct DkvTcSmem")
    kv_b = src.index("// stats: scratch of 3 x")

    def no_softmax(s):
        s = _sub(s, dq_a, kv_a,
                 "float p = ex2(fmaf(round_bf16(sc[4 * n + e]), sl2, -mlog[h])) * invl[h];",
                 "float p = sc[4 * n + e];")
        s = _sub(s, dq_a, kv_a, "dp[4 * n + e] = p * (round_bf16(dp[4 * n + e]) - dlt[h]) * scale;",
                 "dp[4 * n + e] = p * dp[4 * n + e];")
        s = _sub(s, kv_a, kv_b, "float p = ex2(fmaf(round_bf16(sc[e]), sl2, -mlog)) * invl;",
                 "float p = sc[e];")
        return _sub(s, kv_a, kv_b, "dp[e] = p * (round_bf16(dp[e]) - dlt) * scale;",
                    "dp[e] = p * dp[e];")

    def no_products(s):
        seg = re.sub(r"tc::wgmma_bf16<[^>]*>\([^;]*\);", ";", s[dq_a:kv_b], flags=re.S)
        return s[:dq_a] + seg + s[kv_b:]

    def no_streaming(s):
        s = _sub(s, dq_a, kv_a, "if (j + kDqAhead < ntiles) issue_kv(j + kDqAhead);",
                 "if (false) issue_kv(j + kDqAhead);")
        s = _sub(s, dq_a, kv_a, "const unsigned char* ks = ring + (j % kRing) * (S::kK + S::kV);",
                 "const unsigned char* ks = ring;")
        s = _sub(s, kv_a, kv_b, "if (j + kDkvAhead < ntiles) issue_q(j + kDkvAhead);",
                 "if (false) issue_q(j + kDkvAhead);")
        return _sub(s, kv_a, kv_b, "const unsigned char* qs = ring + (j % kRing) * S::kStage;",
                    "const unsigned char* qs = ring;")

    def no_loop(s):
        return _sub(s, dq_a, kv_a, "const int ntiles = (kv_end + kBN - 1) / kBN;",
                    "const int ntiles = 0 * kv_end;")

    return {"base": src, "no_softmax": no_softmax(src), "no_products": no_products(src),
            "no_streaming": no_streaming(src), "no_loop": no_loop(src),
            "skeleton": no_streaming(no_products(no_softmax(src)))}


def fwd_variants(src: str) -> dict:
    """{name: patched flash_attention.cu} for the forward."""
    a = src.index("flash_fwd_tc_kernel(const bf16*")
    b = src.index("cudaError_t launch_fwd_tc(")
    c = src.index("extern \"C\" int sct_flash_attention_fwd")

    def no_softmax(s):
        s = _sub(s, a, b, "float s = round_bf16(sc[4 * n + e]);", "float s = sc[4 * n + e];")
        return _sub(s, a, b, "const float p = ex2(fmaf(sc[4 * n + e], sl2, nm[e >> 1]));",
                    "const float p = sc[4 * n + e];")

    def no_products(s):
        seg = re.sub(r"tc::wgmma_bf16<[^>]*>\([^;]*\);", ";", s[a:b], flags=re.S)
        return s[:a] + seg + s[b:]

    def no_streaming(s):
        s = _sub(s, a, b, "if (j + kFwdAhead < ntiles) issue_kv(j + kFwdAhead);",
                 "if (false) issue_kv(j + kFwdAhead);")
        return _sub(s, a, b, "const unsigned char* ks = ring + (j % kRing) * (F::kK + F::kV);",
                    "const unsigned char* ks = ring;")

    def carveout(s):
        old = "cudaError_t err = sct::allow_smem(kernel, F::kBytes);\n"
        return _sub(s, b, c, old, old + "  if (err == cudaSuccess) err = cudaFuncSetAttribute("
                    "kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n")

    return {"base": src, "no_softmax": no_softmax(src), "no_products": no_products(src),
            "no_streaming": no_streaming(src),
            "skeleton": no_streaming(no_products(no_softmax(src))), "carveout": carveout(src)}


def _patch(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"ablate: {old[:60]!r} not found; the kernel source changed")
        src = src.replace(old, new)
    return src


def mla_variants(src: str) -> dict:
    """{name: patched paged_mla_decode.cu}, for the design the source holds."""
    if "cluster.map_shared_rank(mrow" in src:          # the cluster design
        parts = {
            "no_combine": [("const int t_hi = min(total, (z + 1) * share);",
                            "const int t_hi = 0 * total;")],
            "no_scores": [("for (int d = 0; d < lat / 4; ++d) dl = dot4(qa[d], ka[d], dl);",
                           "dl = qa[0].x * ka[0].x;"),
                          ("for (int d = 0; d < rope / 4; ++d) dr = dot4(qb[d], kb[d], dr);",
                           "(void)qb; (void)kb;")],
            "no_softmax": [("for (int r = tid; r < kHeads; r += kThreads) {\n      const float m_prev",
                            "for (int r = tid; r < 0; r += kThreads) {\n      const float m_prev")],
            "no_pv": [("for (int p = 0; p < page; ++p) {\n        const float2 v",
                       "for (int p = 0; p < 0 * page; ++p) {\n        const float2 v")],
            "no_staging": [("if (kCold && cold.flags[phys] != 0) {", "if (j < 0) {"),
                           ("} else {\n      for (int t = tid; t < page * lat;",
                            "} else if (j < 0) {\n      for (int t = tid; t < page * lat;")],
        }
        extra = {"live_ranks": [("while (splits < 8 && 2 * splits <= n_pages) splits <<= 1;",
                                 "splits = n_pages == 8 ? 6 : 3;")]}
    elif "mla_combine_kernel" in src:                   # the split design
        parts = {
            "no_combine": [("if (err != cudaSuccess || per_slot == 1) return err;",
                            "if (true) return err;")],
            "no_scores": [("for (int kk = k_lo; kk < k_hi; ++kk) {",
                           "for (int kk = k_lo; kk < k_lo; ++kk) {")],
            "no_softmax": [("const float p = expf(s[e] - m_new);", "const float p = s[e];"),
                           ("const float a = expf(m_prev - m_new);", "const float a = 1.f;")],
            "no_pv": [("        if (col < L.lp) {\n          uint32_t bv[4];",
                       "        if (col < 0) {\n          uint32_t bv[4];")],
            "no_staging": [("bool cold_now = stage(0, 0);", "bool cold_now = false;"),
                           ("if (tau + 1 < ntiles) cold_next = stage(tau + 1, buf ^ 1);",
                            "(void)buf;")],
        }
        extra = {"no_q_load": [("if (r < nh && cc < (lat_part ? lat : rope))\n        load4",
                                "if (false)\n        load4")],
                 "direct_out": [("        if (direct)\n", "        if (true)\n")]}
    else:
        raise SystemExit("ablate: paged_mla_decode.cu holds neither known design")

    out = {"base": src}
    out.update({name: _patch(src, subs) for name, subs in parts.items()})
    out["skeleton"] = _patch(src, [sub for subs in parts.values() for sub in subs])
    out.update({name: _patch(src, subs) for name, subs in extra.items()})
    return out


def gqa_variants(src: str) -> dict:
    """{name: patched paged_decode.cu}, for the design the source holds."""
    if "cluster.map_shared_rank(mrow" in src:          # the cluster design
        parts = {
            "no_combine": [("const int t_hi = min(rep * hd, (z + 1) * share);",
                            "const int t_hi = 0 * share;")],
            "no_staging": [("if (kCold && cold.flags[phys] != 0) {", "if (j < 0) {"),
                           ("} else {\n      for (int t = tid; t < page * hd;",
                            "} else if (j < 0) {\n      for (int t = tid; t < page * hd;")],
            "no_scores": [("for (int d = 0; d < hd; ++d) dot = fmaf(qs[r * hd + d], "
                           "ks[p * hdp + d], dot);", "dot = qs[r * hd] * ks[p * hdp];")],
            "no_softmax": [("for (int r = tid; r < rep; r += kThreads) {\n      const float m_prev",
                            "for (int r = tid; r < 0; r += kThreads) {\n      const float m_prev")],
            "no_pv": [("for (int p = 0; p < page; ++p) o = fmaf(ps[r * page + p]",
                       "for (int p = 0; p < 0 * page; ++p) o = fmaf(ps[r * page + p]")],
        }
        old = "while (splits < 8 && 2 * splits <= n_pages) splits <<= 1;"
        extra = {f"cluster_{n}": [(old, f"splits = {n};")] for n in (1, 2, 4, 8)}
    elif "kWarps" in src:                               # the warp-a-page design
        parts = {
            "no_combine": [("for (int d = threadIdx.x; d < G.hd; d += kWarps * 32) {",
                            "for (int d = threadIdx.x; d < 0 * G.hd; d += kWarps * 32) {")],
            "no_staging": [("const bool ok = live && dims && rr < rows && pos0 + rr <= len;",
                            "const bool ok = false;"),
                           ("live && dims && !hot, U.ks);", "false, U.ks);"),
                           ("live && dims && !hot, U.vs);", "false, U.vs);")],
            "no_scores": [("for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kf[e], dot);",
                           "dot = qv[0] * kf[0];"),
                          ("dot = reduce<kLp, true>(dot, LP, Add{});", "(void)LP;")],
            "no_softmax": [("const float alpha = exp2f(__fsub_rn(m, m_new));",
                            "const float alpha = 1.f;"),
                           ("sc[s] = valid[s] ? exp2f(__fsub_rn(sc[s], m_new)) : 0.f;",
                            "sc[s] = valid[s] ? __fsub_rn(sc[s], m_new) : 0.f;"),
                           ("mx = reduce<kLp, false>(mx, LP, Max{});", "(void)0;")],
            "no_pv": [("for (int e = 0; e < E; ++e) acc[e] = fmaf(sc[s], vf[e], acc[e]);",
                       "acc[0] = fmaf(sc[s], vf[0], acc[0]);")],
        }
        old = "constexpr int kWarps = 8;"
        extra = {f"warps_{n}": [(old, f"constexpr int kWarps = {n};")] for n in (4, 16)}
    else:
        raise SystemExit("ablate: paged_decode.cu holds neither known design")
    out = {"base": src}
    out.update({name: _patch(src, subs) for name, subs in parts.items()})
    out["skeleton"] = _patch(src, [sub for subs in parts.values() for sub in subs])
    out.update({name: _patch(src, subs) for name, subs in extra.items()})
    return out


def mlstm_variants(src: str) -> dict:
    """{name: patched mlstm_chunk.cu}."""
    subs = {
        "scores_no_load": [("  stage(d_lo, 0);\n", "  (void)d_lo;\n"),
                           ("if (st + 1 < nst) stage(d_lo + (st + 1) * kSK, buf ^ 1);", ";")],
        "scores_no_fma": [("          acc[r][s] = fmaf(a[r].y, bb[s].y, acc[r][s]);\n"
                           "          acc[r][s] = fmaf(a[r].z, bb[s].z, acc[r][s]);\n"
                           "          acc[r][s] = fmaf(a[r].w, bb[s].w, acc[r][s]);\n", "")],
        "state_one_pass": [("            mma_tf32(creg[mi][nt], as[mi], bb0, bb1);\n"
                            "            mma_tf32(creg[mi][nt], ab[mi], bs0, bs1);\n", "")],
        "out_no_stats": [("  chunk_stats(i_pre, f_pre, row0, tc, sm.bcum, sm.ii, sm.dsc);\n"
                          "  sct::grid_dependency_wait();", "  sct::grid_dependency_wait();")],
        "out_no_w": [("      if (r < nr && j <= t) {\n        float sv[kMaxSlices];",
                      "      if (r < 0) {\n        float sv[kMaxSlices];")],
        "out_no_gemm": [("    for (int kk = 0; kk < jn; kk += 8) {", "    for (int kk = 0; kk < 0; kk += 8) {")],
    }
    out = {"base": src}
    out.update({name: _patch(src, pairs) for name, pairs in subs.items()})
    return out


def mlstm_bwd_variants(src: str) -> dict:
    """{name: patched mlstm_chunk_bwd.cu}, for the design the source holds."""
    if "tile_product<true, true>(st," in src:            # the CUDA-core design
        a = src.index("bwd_scores_kernel(const float*")
        b = src.index("// " + "-" * 66 + " rows --")
        parts = {
            "no_carried": [("tile_product<true, true>(st,",
                            "if (false) tile_product<true, true>(st,"),
                           ("tile_product<true, false>(st,",
                            "if (false) tile_product<true, false>(st,")],
            "no_triangle": [("tile_product<true, false>(acc,",
                             "if (false) tile_product<true, false>(acc,"),
                            ("tile_product<false, false>(acc,",
                             "if (false) tile_product<false, false>(acc,")],
            "no_dc_update": [("for (int j = 0; j < jn; ++j) {\n        const float cj",
                              "for (int j = 0; j < 0; ++j) {\n        const float cj")],
        }

        def scores_fp32(s):
            s = _sub(s, a, b, "double acc[4][4] = {};", "float acc[4][4] = {};")
            return _sub(s, a, b, "static_cast<double>(", "(")
        out = {"base": src}
        out.update({name: _patch(src, subs) for name, subs in parts.items()})
        out["scores_fp32"] = scores_fp32(src)
        out["skeleton"] = scores_fp32(_patch(src, [sub for subs in parts.values() for sub in subs]))
        return out
    if "wg_step(" not in src:
        raise SystemExit("ablate: mlstm_chunk_bwd.cu holds no known design")
    # the tensor-core design: both products of the dC sweep and the input
    # gradients as wgmma stages (raw rows in flight, the next stage split
    # while the tensor cores run this one)
    passes = ("  wgmma_tf32_n128(part, as, db, kk > 0);\n"
              "  wgmma_tf32_n128(part, ab, ds, 1);\n"
              "  wgmma_tf32_n128(part, ab, db, 1);\n")
    parts = {
        "no_wgmma": [(passes, "  (void)db; (void)ds;\n")],
        "no_split": [("  for (int i = 0; i < kCores / 4; ++i) {",
                      "  for (int i = 0; i < 0; ++i) {")],
        "no_loads": [("if (kk == 0 && s + kRaw - 1 < n_stages) issue(s + kRaw - 1);", ";"),
                     ("if (kk == 0 && s + kRaw - 1 < ntot) issue(s + kRaw - 1);", ";")],
        "no_flush": [("acc[i] += part[i];", "(void)part[i];")],
    }
    out = {"base": src}
    out.update({name: _patch(src, subs) for name, subs in parts.items()})
    out["one_pass"] = _patch(src, [(passes, "  (void)ds;\n"
                                            "  wgmma_tf32_n128(part, ab, db, kk > 0);\n")])
    out["raw_3"] = _patch(src, [("constexpr int kRaw = 4;", "constexpr int kRaw = 3;")])
    out["near_loads"] = _patch(src, [("    const int k = k0 + kk;\n",
                                      "    const int k = (k0 & 63) + kk;\n")])
    out["skeleton"] = _patch(src, [sub for name in ("no_wgmma", "no_split", "no_loads")
                                   for sub in parts[name]])
    return out


def mamba_variants(src: str, tree: Path) -> dict:
    """{name: patched mamba_scan.cu}, for the design the source holds; a
    variant that patches other files of ``tree`` is {path: text}."""
    body = "const int tid = threadIdx.x;"
    if "__shfl_xor_sync(0xffffffffu, acc, 1)" in src:     # states over 4 lanes
        parts = {
            "no_staging": [("for (int e = tid; e < kTT * kChannels; e += kThreads) {\n"
                            "      const int r = e / kChannels, col = e % kChannels;\n"
                            "      const bool ok",
                            "for (int e = tid; e < 0; e += kThreads) {\n"
                            "      const int r = e / kChannels, col = e % kChannels;\n"
                            "      const bool ok"),
                           ("for (int e = tid; e < kTT * ds; e += kThreads) {",
                            "for (int e = tid; e < 0; e += kThreads) {")],
            "no_exp": [("const float dA = expf(__fmul_rn(dtt, a[i]));",
                        "const float dA = __fmul_rn(dtt, a[i]);")],
            "no_shuffle": [("acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));\n"
                            "      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));",
                            "")],
            "no_writeback": [("y[(row0 + t0 + r) * di + c0 + col] = sct::from_float<T>(ys[r][col]);",
                              "(void)0;")],
        }
        extra = {"empty": [(body, "if (S > 0) return;\n  " + body)]}
    elif "kStates" in src:                                 # states over lanes, step groups
        parts = {
            "no_staging": [("const uint4 pu = *reinterpret_cast<const uint4*>(u + off);",
                            "const uint4 pu = make_uint4(0, 0, 0, 0);"),
                           ("const uint4 pd = *reinterpret_cast<const uint4*>(dt + off);",
                            "const uint4 pd = make_uint4(0, 0, 0, 0);"),
                           ("      const bool ok = r < nt;\n      br[i]",
                            "      const bool ok = false;\n      br[i]")],
            "no_exp": [("dA[s][i] = expf(__fmul_rn(ud[s].y, a[i]));",
                        "dA[s][i] = __fmul_rn(ud[s].y, a[i]);")],
            "no_shuffle": [("for (int w = 1; w < kGroups; w *= 2)",
                            "for (int w = 1; w < 1; w *= 2)")],
            "no_ywrite": [("if (e >= kPiecesTile || r >= nt) break;", "if (e >= 0) break;")],
        }
        extra = {"empty": [("const int cl = threadIdx.x / kGroups, g = threadIdx.x % kGroups;",
                            "if (S > 0) return;\n  "
                            "const int cl = threadIdx.x / kGroups, g = threadIdx.x % kGroups;")],
                 "exp2": [("a[i] = live ? load_param(A, (size_t)c * kDs + g * kStates + i, "
                           "ad_bf16) : 0.f;",
                           "a[i] = live ? __fmul_rn(load_param(A, (size_t)c * kDs + g * kStates"
                           " + i, ad_bf16), 1.44269504f) : 0.f;"),
                          ("dA[s][i] = expf(__fmul_rn(ud[s].y, a[i]));",
                           "dA[s][i] = exp2f(__fmul_rn(ud[s].y, a[i]));")],
                 "steps_1": [("constexpr int kU = kStates >= 32 ? 1 : 32 / kStates;",
                              "constexpr int kU = 1;")]}
        # states a thread at d_state 16: the plan's table in the wrapper and
        # the kernel's instance
        table = "STATES = {4: 4, 8: 4, 16: 4, 32: 8, 64: 16}"
        for n in (2, 8):
            extra[f"states_{n}"] = {
                PLAN_SRC: [(table, table.replace("16: 4", f"16: {n}"))],
                MAMBA_SRC: [("  SCT_SCAN(16, 4)\n", f"  SCT_SCAN(16, {n})\n")]}
    else:
        raise SystemExit("ablate: mamba_scan.cu holds neither known design")
    out = {"base": src}
    out.update({name: _patch(src, subs) for name, subs in parts.items()})
    out["skeleton"] = _patch(src, [sub for subs in parts.values() for sub in subs])
    for name, subs in extra.items():
        # a dict patches other files of the port (by path) and keeps the kernel
        out[name] = ({path: _patch((tree / path).read_text(), pairs)
                      for path, pairs in subs.items()} if isinstance(subs, dict)
                     else _patch(src, subs))
    return out


def mamba_bwd_variants(src: str, tree: Path) -> dict:
    """{name: patched mamba_scan_bwd.cu}, for the design the source holds; a
    variant that patches other files of ``tree`` is {path: text}."""
    if "float* const sG = sH + kRow * kDs;" in src:     # stretch in shared memory
        parts = {
            "no_channel_sums": [("for (int e = threadIdx.x; e < nt * kDs; e += kThreads) {",
                                 "for (int e = threadIdx.x; e < 0; e += kThreads) {")],
            "no_state_sums": [("      tree_sum<kStates>(pb);\n      tree_sum<kStates>(pa);\n", ""),
                              ("for (int w = 1; w < kGroups; w *= 2) {\n        sb",
                               "for (int w = 1; w < 1; w *= 2) {\n        sb")],
            "no_staging": [("for (int e = threadIdx.x; e < kRow; e += kThreads) {",
                            "for (int e = threadIdx.x; e < 0; e += kThreads) {"),
                           ("for (int e = threadIdx.x; e < kRec * kDs; e += kThreads) {",
                            "for (int e = threadIdx.x; e < 0; e += kThreads) {")],
            "no_recompute_stores": [("          hp[i] = h[i];\n          ep[i] = e;",
                                     "          if (__float_as_uint(h[i]) == 0x7fc00001u) hp[i] = e;")],
        }
        extra = {}
    elif "forward_group<P, true, false>(x" in src:        # the stretch in registers
        parts = {
            "no_channel_sums": [("  float v[kPer];\n  row_tree",
                                 "  if (t >= 0) return;\n  float v[kPer];\n  row_tree")],
            "no_state_sums": [("for (int e = lane; e < kSub * kCW; e += 32) {",
                               "for (int e = lane; e < 0; e += 32) {")],
            "no_staging": [("  auto stage = [&](int k) {\n",
                            "  auto stage = [&](int k) {\n    if (k >= 0) return;\n")],
            "no_convert": [("  auto convert = [&]() {\n",
                            "  auto convert = [&]() {\n    if (tid >= 0) return;\n")],
        }
        table = "BWD_STATES = {4: 4, 8: 4, 16: 4, 32: 8, 64: 16}"
        built = "X(4, 4) X(8, 4) X(16, 4) X(32, 8) X(64, 16)"
        extra = {
            "no_recompute": [("      forward_group<P, true, false>(x, grp * kU, a, h, e, eh);",
                              "      (void)0;")],
            "no_exp": [("ex[jj][i] = expf(__fmul_rn(dtv[jj], a[i]));",
                        "ex[jj][i] = __fmul_rn(dtv[jj], a[i]);")],
            "no_partials": [("  auto write_partials = [&](int k, float* __restrict__ part) {\n",
                             "  auto write_partials = [&](int k, float* __restrict__ part) {\n"
                             "    if (k >= 0) return;\n")],
            "min_blocks_3": [("kSmemBlocks < 4 ? kSmemBlocks : 4;", "3;")],
            "reverse_quads": [("  constexpr int kQ = kU < 2 ? kU : 2;  // steps of dt, u, dy a load\n"
                               "  const int s0 = x.g * kStates;\n",
                               "  constexpr int kQ = kU < 4 ? kU : 4;  // steps of dt, u, dy a load\n"
                               "  const int s0 = x.g * kStates;\n")],
        }
        for n in (2, 8):
            extra[f"states_{n}"] = {
                PLAN_SRC: [(table, table.replace("16: 4", f"16: {n}"))],
                MAMBA_BWD_SRC: [(built, built.replace("X(16, 4)", f"X(16, {n})"))]}
    else:
        raise SystemExit("ablate: mamba_scan_bwd.cu holds no known design")
    out = {"base": src}
    out.update({name: _patch(src, subs) for name, subs in parts.items()})
    out["skeleton"] = _patch(src, [sub for subs in parts.values() for sub in subs])
    for name, subs in extra.items():
        out[name] = ({path: _patch((tree / path).read_text(), pairs)
                      for path, pairs in subs.items()} if isinstance(subs, dict)
                     else _patch(src, subs))
    return out


# the walk and the reduction of #8b, by a piece of their kernels' names
MAMBA_BWD_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.mamba_scan import mamba_scan_bwd_cuda, mamba_scan_cuda
from repro_torch.kernels.testing import mamba_inputs, mamba_model_layout
args = mamba_model_layout(*mamba_inputs(2, 4096, 8192, 16, "unit", dtype=torch.bfloat16,
                                        seed=cs.SEED + 17, device="cuda"), dt_rank=256)
y, _, hs = mamba_scan_cuda(*args, record=True)
dy = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 18),
                 device="cuda").to(y.dtype)
ms = cs.time_cold(torch, lambda: mamba_scan_bwd_cuda(*args, hs, dy), iters=10)
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        flush.zero_()
        mamba_scan_bwd_cuda(*args, hs, dy)
    torch.cuda.synchronize()
rows = {"walk": 0.0, "reduce": 0.0}
for t, c, key in cs.device_rows(torch, prof):
    if "mamba_scan_bwd" in key:
        rows["reduce" if "reduce" in key else "walk"] += t / 5
print(f"call {ms:.4f} ms; walk {rows['walk']:.4f}, reduce {rows['reduce']:.4f}")
'''


MAMBA_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke as cs
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.testing import mamba_inputs
ms = []
for S in (cs.MLSTM_PREFILL_S, 4096):
    u, dt, B, C, A, D = mamba_inputs(1, S, 8192, 16, "unit", dtype=torch.bfloat16,
                                     seed=cs.SEED + 12, device="cuda")
    ms.append(cs.time_cold(torch, lambda: mamba_scan_cuda(u, dt, B, C, A, D)))
print(f"S 160 {ms[0]:.4f} ms, S 4096 {ms[1]:.4f} ms")
'''


MLSTM_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.testing import mlstm_inputs
q, k, v, i, f, _ = mlstm_inputs(4, 160, 1024, "unit", seed=cs.SEED + 11, device="cuda")
ms = cs.time_cold(torch, lambda: mlstm_chunk(q, k, v, i, f))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        mlstm_chunk(q, k, v, i, f)
    torch.cuda.synchronize()
rows = {key.split("mlstm_")[1].split("_kernel")[0]: t / c for t, c, key in cs.device_rows(torch, prof)
        if "mlstm_" in key}
print(f"call {ms:.4f} ms; " + ", ".join(f"{k} {t:.4f}" for k, t in sorted(rows.items())))
'''


# the six launches of the mLSTM backward, by a piece of their kernels' names
MLSTM_BWD_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_bwd_cuda
from repro_torch.kernels.testing import mlstm_inputs
q, k, v, i, f, _ = mlstm_inputs(8, 4096, 1024, "unit", seed=cs.SEED + 12, device="cuda")
y, _ = mlstm_chunk(q, k, v, i, f)
dy = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 13),
                 device="cuda")
args = (q, k, v, i, f, None, y, dy, None, None, None)
ms = cs.time_cold(torch, lambda: mlstm_chunk_bwd_cuda(*args), iters=10)
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        flush.zero_()
        mlstm_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
parts = ("mlstm_state", "bwd_scores", "bwd_rows", "bwd_dstate", "bwd_inputs", "bwd_gates")
rows = {}
for t, c, key in cs.device_rows(torch, prof):
    for name in parts:
        if name in key:
            rows[name] = rows.get(name, 0.0) + t / 5
print(f"call {ms:.4f} ms; " + ", ".join(f"{n} {rows.get(n, 0.0):.4f}" for n in parts)
      + f" (sum {sum(rows.values()):.4f})")
'''


MLA_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke as cs
from repro_torch.kernels.paged_decode import paged_mla_decode, paged_mla_decode_cold
cfg = cs.deepseek_config(cs.DEEPSEEK_LAYERS)
scale = cs.mla_scale(cfg)
hot_lens = [p + g // 2 for p, g in cs.TRACE[:cs.SLOTS]]
hot = cs.mla_case(torch, hot_lens, cs.PAGES_PER_SEQ, cfg, torch.float32, null_slot=False,
                  seed=cs.SEED + 17)
cold_lens = [cs.SINK * cs.PAGE + cs.WINDOW * cs.PAGE + cs.PAGE - 1] * cs.STREAM_SLOTS
cold = cs.mla_case(torch, cold_lens, cs.STREAM_PAGES_PER_SEQ, cfg, torch.float32,
                   null_slot=False, p_cold=0.0, seed=cs.SEED + 17)
cold[10][cold[8][:, cs.SINK].long()] = 1          # one cold page a slot
t_hot = cs.time_cold(torch, lambda: paged_mla_decode(*hot, scale=scale))
t_cold = cs.time_cold(torch, lambda: paged_mla_decode_cold(*cold, scale=scale))
print(f"hot {t_hot:.4f} ms, cold {t_cold:.4f} ms")
'''


GQA_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke as cs
from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
hot_lens = [p + g // 2 for p, g in cs.TRACE[:cs.SLOTS]]
hot = cs.paged_inputs(torch, hot_lens, cs.PAGES_PER_SEQ, 8, 4, 64, torch.bfloat16, gen,
                      null_slot=False)
cold_lens = [cs.SINK * cs.PAGE + cs.WINDOW * cs.PAGE + cs.PAGE - 1] * cs.STREAM_SLOTS
cold = cs.cold_inputs(torch, cold_lens, cs.STREAM_PAGES_PER_SEQ, 8, 4, 64, torch.bfloat16, gen,
                      null_slot=False, p_cold=0.0)
cold[9][cold[7][:, cs.SINK].long()] = 1          # one cold page a slot
t_hot = cs.time_cold(torch, lambda: paged_gqa_decode(*hot))
t_cold = cs.time_cold(torch, lambda: paged_gqa_decode_cold(*cold))
print(f"hot {t_hot:.4f} ms, cold {t_cold:.4f} ms")
'''


FWD_TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke as cs
from repro_torch.kernels.flash_attention import flash_attention_fwd
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v, _ = cs.flash_inputs(torch, 2, 4096, 32, 1, 64, torch.bfloat16, gen)
print(f"fwd {cs.time_cold(torch, lambda: flash_attention_fwd(q, k, v)):.4f} ms")
'''


TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.flash_ref import flash_fwd_ref
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = cs.flash_inputs(torch, 2, 4096, 32, 1, 64, torch.bfloat16, gen)
out, m, l = flash_fwd_ref(q, k, v)
for _ in range(3):
    flash_attention_bwd(q, k, v, out, m, l, do)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        flash_attention_bwd(q, k, v, out, m, l, do)
    torch.cuda.synchronize()
ms = {("dq" if "dq_tc" in key else "dkdv"): t / c for t, c, key in cs.device_rows(torch, prof)
      if "_tc_kernel" in key}
print(f"dkdv {ms.get('dkdv', 0.0):.4f} ms, dq {ms.get('dq', 0.0):.4f} ms")
'''


def main() -> int:
    argv = sys.argv[1:]
    fwd, mla, mlstm, gqa, mamba = ("--fwd" in argv, "--mla" in argv, "--mlstm" in argv,
                                   "--gqa" in argv, "--mamba" in argv)
    mlstm_bwd, mamba_bwd = "--mlstm-bwd" in argv, "--mamba-bwd" in argv
    tree = Path(argv[argv.index("--src") + 1]).resolve().parent if "--src" in argv else ROOT
    path = (MLA_SRC if mla else MLSTM_SRC if mlstm else MLSTM_BWD_SRC if mlstm_bwd else
            GQA_SRC if gqa else MAMBA_SRC if mamba else MAMBA_BWD_SRC if mamba_bwd else SRC)
    src = (tree / path).read_text()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if mla:
        table, timer = mla_variants(src), MLA_TIMER
    elif gqa:
        table, timer = gqa_variants(src), GQA_TIMER
    elif mlstm:
        table, timer = mlstm_variants(src), MLSTM_TIMER
    elif mlstm_bwd:
        table, timer = mlstm_bwd_variants(src), MLSTM_BWD_TIMER
    elif mamba:
        table, timer = mamba_variants(src, tree), MAMBA_TIMER
    elif mamba_bwd:
        table, timer = mamba_bwd_variants(src, tree), MAMBA_BWD_TIMER
    else:
        table, timer = (fwd_variants(src), FWD_TIMER) if fwd else (variants(src), TIMER)
    if "--only" in argv:                      # a comma-separated subset of the variants
        keep = argv[argv.index("--only") + 1].split(",")
        table = {name: table[name] for name in keep}
    for name, patched in table.items():
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(tree / "src", dst / "src",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for file, text in (patched.items() if isinstance(patched, dict) else [(path, patched)]):
            (dst / file).write_text(text)
        run = subprocess.run([sys.executable, "-c", timer, str(dst / "src"), str(ROOT)],
                             capture_output=True, text=True, env=dict(os.environ))
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        print(f"[ablate] {name}: {run.stdout.strip().splitlines()[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
