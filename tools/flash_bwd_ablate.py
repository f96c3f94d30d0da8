#!/usr/bin/env python3
"""Where the bf16 flash backward's (or forward's) time goes, by ablation,
on one GPU.

    python3 tools/flash_bwd_ablate.py [--fwd]

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

The variants compute wrong results: they are timings only. Needs no JAX.
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
        s = _sub(s, dq_a, kv_a, "const unsigned char* ks = ring + (j % kRing) * 2 * S::kKV;",
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
        return _sub(s, a, b, "const unsigned char* ks = ring + (j % kRing) * 2 * F::kKV;",
                    "const unsigned char* ks = ring;")

    def carveout(s):
        old = "cudaError_t err = sct::allow_smem(kernel, F::kBytes);\n"
        return _sub(s, b, c, old, old + "  if (err == cudaSuccess) err = cudaFuncSetAttribute("
                    "kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n")

    return {"base": src, "no_softmax": no_softmax(src), "no_products": no_products(src),
            "no_streaming": no_streaming(src),
            "skeleton": no_streaming(no_products(no_softmax(src))), "carveout": carveout(src)}


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
    fwd = "--fwd" in sys.argv[1:]
    src = (ROOT / SRC).read_text()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, patched in (fwd_variants(src) if fwd else variants(src)).items():
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "src", dst / "src",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (dst / SRC).write_text(patched)
        run = subprocess.run([sys.executable, "-c", FWD_TIMER if fwd else TIMER,
                              str(dst / "src"), str(ROOT)],
                             capture_output=True, text=True, env=dict(os.environ))
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        print(f"[ablate] {name}: {run.stdout.strip().splitlines()[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
