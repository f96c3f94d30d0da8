#!/usr/bin/env python3
"""Check and time the port's two tensor-core kernels on one GPU: the bf16
spectral matmul (``csrc/spectral_matmul_tc.cu``) and the bf16 flash
backward (``csrc/flash_attention.cu``, the ``*_tc_kernel``s).

    PYTHONPATH=src python3 tools/tc_probe.py [--quick | --split]

Builds the kernels, prints each kernel's registers and spills, holds both
against their plain versions at the main paths' shapes, checks the
spectral kernel's batch invariance (rows of M = 1/4/37/64/160/8192 against
the row alone) and the backward's determinism, then times, with
``chip_smoke.time_cold`` (cold-L2 device-time medians): one decode
layer's MLP (3 launches, M 4), the 64-row prefill chunk, both training
projections (M 8192), against the plain version and the three-GEMM
chain; the flash backward at smollm2-1.7b's training shape against SDPA's
backward. ``--quick`` skips the timing; ``--split`` adds each backward
kernel's device time (``torch.profiler``) and the spectral kernel at
shapes that leave one phase (a 256-wide m or n). Needs no JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="also time phase-isolating shapes and each backward kernel")
    args = ap.parse_args()
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
    build.library()
    for src, report in build.BUILD_LOG.get("ptxas", {}).items():
        for line in report.splitlines():
            if ("registers" in line or "spill" in line) and src in (
                    "spectral_matmul_tc.cu", "flash_attention.cu"):
                print(f"[build] {src}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    # ---- spectral: correctness, invariance ----
    shapes = [(4, 2048, 8192, 128), (4, 8192, 2048, 128), (64, 2048, 8192, 128),
              (160, 2730, 2048, 128), (4, 4096, 14336, 256), (160, 14336, 4096, 256),
              (8192, 2048, 8192, 128), (8192, 8192, 2048, 128), (37, 300, 700, 64)]
    for M, m, n, k in shapes:
        a = cs.spectral_inputs(torch, M, m, n, k, bf, gen)
        e = compare_kernel(spectral_matmul, spectral_matmul_ref, a,
                           label=f"spectral {M}x{m}->{n} r{k}")
        print(f"[spectral] {M}x{m}->{n} rank {k}: max abs {e.max_abs:.3e}, "
              f"scaled {e.max_scaled:.3e}")
    for m, n, k in ((2048, 8192, 128), (8192, 2048, 128), (2048, 8192, 256)):
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
                 (2, 256, 2, 2, 128), (1, 300, 1, 3, 64)):
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
    print(f"[time] flash_attention_bwd (2, 4096, 32 heads, d 64): kernel {ms:.4f} ms, "
          f"SDPA backward {lib:.4f}, bound {2.5 * 137.4e9 / 989e12 * 1e3:.4f}")
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
