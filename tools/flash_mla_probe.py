#!/usr/bin/env python3
"""Check and time the flash kernels (``csrc/flash_attention.cu``) at
deepseek's MLA widths (q/k 192, v 128) on one GPU, and hold the GQA widths'
bits.

    PYTHONPATH=src python3 tools/flash_mla_probe.py [--quick] [--src DIR]
    python3 tools/flash_mla_probe.py --digests [--src DIR]
    python3 tools/flash_mla_probe.py --digests-against DIR
    python3 tools/flash_mla_probe.py --time-gqa [--src DIR]
    python3 tools/flash_mla_probe.py --time-mla [--src DIR]

With no mode flag it builds the kernels and prints the registers, shared
memory and spills of every flash kernel (ptxas -v). Then it holds the
forward (out, m, l) and the backward (dq, dk, dv) at (192, 128) against
their plain versions under the tolerance ladder, in bf16 and fp32, at
``CASES``: MLA's training shape (b 2, s 4096, 128 heads, r 1), a ragged
length, short lengths and grouped heads. It requires two calls to give
the same bits. Last it times both kernels at the training shape
(``chip_smoke.time_flash``: cold-L2 device-time medians) against their
plain versions, one SDPA call (its kernels named) and the bound.
``--quick`` skips the timing.

``--digests`` prints ``chip_smoke.flash_digests`` (the (64, 64) and (128,
128) outputs' digests on numpy inputs) for the port under ``--src``.
``--digests-against DIR`` runs that for this tree and for DIR (another
checkout's ``src``, e.g. the parent commit's ``git archive`` unpacked into a
git-ignored directory), each in its own process, and compares them with
each other and with ``chip_smoke.FLASH_DIGESTS``.

``--time-gqa`` times the kernels at the GQA widths only (``chip_smoke.time_flash``
at smollm2-1.7b's training shape, d 64, and jamba's attention, d 128) for
the port under ``--src``: run it over two trees in turns (parent, change,
change, parent) in one call to compare them on one card. ``--time-mla``
does the same at MLA's training shape (b 2, s 4096, 128 heads, r 1, q/k
192, v 128).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

DK, DV = 192, 128
# (dtype, (b, s, g, r)): the training shape (bf16 only: in fp32 chip_smoke.py
# holds it), ragged and short lengths, grouped heads, the largest group
CASES = [("bfloat16", (2, 4096, 128, 1)), ("bfloat16", (1, 1000, 4, 1)),
         ("bfloat16", (1, 37, 3, 1)), ("bfloat16", (1, 64, 2, 1)),
         ("bfloat16", (1, 300, 2, 4)), ("bfloat16", (1, 130, 1, 64)),
         ("float32", (1, 4096, 8, 1)), ("float32", (1, 1000, 4, 1)),
         ("float32", (1, 37, 3, 1)), ("float32", (1, 300, 2, 4)),
         ("float32", (1, 130, 1, 64))]


def check(torch, cs):
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref
    from repro_torch.kernels.testing import compare_kernel

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    worst = {}
    for name, (b, s, g, r) in CASES:
        dtype = getattr(torch, name)
        q, k, v, do = cs.flash_inputs(torch, b, s, g, r, DK, dtype, gen, dv=DV)
        got, ref = flash_attention_fwd(q, k, v), flash_fwd_ref(q, k, v)
        errs = []
        for i, what in enumerate(("out", "m", "l")):
            e = compare_kernel(lambda: got[i], lambda: ref[i], (), dtype=dtype,
                               label=f"fwd {what} {(b, s, g, r)} {name}")
            errs.append(e.max_scaled)
        again = flash_attention_fwd(q, k, v)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"fwd {(b, s, g, r)} {name}: two calls differ")
        args = (q, k, v, *ref, do)
        gb, rb = flash_attention_bwd(*args), flash_bwd_ref(*args)
        for i, what in enumerate(("dq", "dk", "dv")):
            if gb[i].shape != (q, k, v)[i].shape:
                raise AssertionError(f"bwd {what}: shape {tuple(gb[i].shape)}")
            e = compare_kernel(lambda: gb[i], lambda: rb[i], (), dtype=dtype,
                               label=f"bwd {what} {(b, s, g, r)} {name}")
            errs.append(e.max_scaled)
        again = flash_attention_bwd(*args)
        if not all(torch.equal(a, c) for a, c in zip(gb, again)):
            raise AssertionError(f"bwd {(b, s, g, r)} {name}: two calls differ")
        print(f"[check] (192, 128) {name} b={b} s={s} g={g} r={r}: within the ladder, two calls "
              f"the same bits; max scaled errors out/m/l/dq/dk/dv "
              + "/".join(f"{x:.2e}" for x in errs))
        worst[name] = max(worst.get(name, 0.0), *errs)
        del q, k, v, do, got, ref, gb, rb, args, again
        torch.cuda.empty_cache()
    print(f"[check] worst scaled errors by dtype: {worst}")


def digests_of(src: str) -> dict:
    out = subprocess.run([sys.executable, __file__, "--digests", "--src", src],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="checks only")
    ap.add_argument("--digests", action="store_true",
                    help="print the (64, 64) and (128, 128) outputs' digests")
    ap.add_argument("--digests-against", metavar="DIR",
                    help="compare this tree's digests with DIR's (another src)")
    ap.add_argument("--time-gqa", action="store_true",
                    help="time the (64, 64) and (128, 128) kernels only")
    ap.add_argument("--time-mla", action="store_true",
                    help="time the (192, 128) kernels at MLA's training shape only")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose port is probed")
    args = ap.parse_args()
    if args.digests_against:
        import chip_smoke as cs

        mine, theirs = digests_of(str(ROOT / "src")), digests_of(args.digests_against)
        for case in mine:
            print(f"[digest] {case}: {mine[case]} here, {theirs.get(case)} in "
                  f"{args.digests_against}, {cs.FLASH_DIGESTS.get(case)} in FLASH_DIGESTS")
        same = mine == theirs
        print(f"[digest] the two trees' (64, 64) and (128, 128) outputs are bit-identical: {same}")
        return 0 if same else 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if args.digests:
        print(json.dumps(cs.flash_digests(torch)))
        return 0
    if args.time_gqa or args.time_mla:
        build.library()
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 32)
        mode = "gqa" if args.time_gqa else "mla"
        shapes = (((2, 4096, 32, 32, 64, 64), (2, 4096, 32, 8, 128, 128)) if args.time_gqa
                  else ((2, 4096, 128, 128, DK, DV),))
        for b, s, h, g, d, dv in shapes:
            fwd, bwd = cs.time_flash(torch, b, s, h, g, d, gen, dv=dv)
            print(f"[time-{mode}] d {d}/{dv} (b {b}, s {s}, heads {h}/{g}): forward "
                  f"{fwd['ms']:.4f} ms, backward {bwd['ms']:.4f} ms ({args.src}; "
                  f"{cs.nvidia_smi()})")
        return 0
    from tc_probe import print_ptxas

    build.library()
    print_ptxas(build, ("flash_attention.cu",))
    print(f"[card] {cs.nvidia_smi()}")
    check(torch, cs)
    if not args.quick:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 31)
        fwd, bwd = cs.time_flash(torch, 2, 4096, 128, 128, DK, gen, sdpa_gaps=True, dv=DV)
        for name, t in (("flash_attention_fwd", fwd), ("flash_attention_bwd", bwd)):
            bound = cs.bound_of(t, "bfloat16")
            print(f"[time] {name} (192, 128) b=2 s=4096 heads=128 r=1: kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms "
                  f"({t['library_kernels']}), bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}), {t['flops'] / 1e12:.3f} TFLOP")
    return 0


if __name__ == "__main__":
    sys.exit(main())
