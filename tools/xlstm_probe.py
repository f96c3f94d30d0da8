#!/usr/bin/env python3
"""Probe, on a GPU, the xlstm serving path: how far a batch-1 decode step
lands from the engine's batched one, and the mLSTM kernel's time.

    python3 tools/xlstm_probe.py

1. xlstm-1.3b at full width (random weights from seed 0): prefills
   request 0 of ``chip_smoke.py``'s trace, then runs one decode step at
   batch 1 and at the engine's 4 slots (the request in row 0), in bf16,
   and once more at batch 1 in fp32. Prints, after every fourth block,
   the largest difference of the hidden states (batch 1 against batch
   4, batch 1 against fp32) over the state's RMS, and the logits'
   differences; then whether a bf16 GEMM at 4096 wide and an fp32
   ``bmm`` give a row (a batch) the same bits at another batch size.
2. ``chip_smoke.py``'s ``phase_xlstm_timing`` twice (the kernel and its
   plain version at the cell's prefill shape), each followed by the
   device time of the kernel's two launches (scores, state) there, from
   ``torch.profiler`` over ten warm calls.

Needs the repository around it and a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def batch_divergence(cfg, device):
    import chip_smoke as cs
    from repro_torch.core.tree import layer_slice
    from repro_torch.models import decode as decode_mod
    from repro_torch.models.lm import _norm_apply, n_periods
    from repro_torch.models.model import init_decode_state, init_model, prefill, serving_params
    from repro_torch.nn import xlstm as xlstm_mod
    from repro_torch.nn.embedding import apply_embedding, apply_lm_head
    from repro_torch.serving.paged_cache import slot_write

    masters = init_model(cfg, seed=cs.SEED, device=device)
    prompt = torch.as_tensor(cs.make_trace(cfg.vocab, cs.SEED)[0].prompt, dtype=torch.int64,
                             device=device)[None]

    def step(params, c, rows):
        """Prefill at batch 1, one decode step at ``rows``; returns
        (logits of row 0, hidden state of row 0 after every block)."""
        dt = torch.bfloat16 if c.dtype == "bfloat16" else torch.float32
        with torch.no_grad():
            lg, one = prefill(params, prompt, c, init_decode_state(c, 1, 256, device=device))
            state = init_decode_state(c, rows, 256, device=device)
            for key, axis in decode_mod.recurrent_slot_axes(c).items():
                slot_write(state[key], axis, 0, one[key])
            toks = torch.zeros((rows, 1), dtype=torch.int64, device=device)
            toks[0, 0] = int(torch.argmax(lg[0, -1]))
            x = apply_embedding(params["embed"], toks, compute_dtype=dt)
            hidden = []
            for i in range(n_periods(c)):
                pp = layer_slice(params["periods"], i)
                for p, mi in decode_mod._ssm_layers(c):
                    lp = pp[f"p{p}"]
                    h = _norm_apply(c, lp["pre_norm"], x)
                    if mi is None:
                        st = layer_slice(state["slstm"], i)
                        h, new = xlstm_mod.apply_slstm_decode(lp["slstm"], h, c, state=st)
                        for name, t in new.items():
                            st[name].copy_(t)
                    else:
                        st = layer_slice(layer_slice(state["mlstm"], i), mi)
                        h, _ = xlstm_mod.apply_mlstm_decode(lp["mlstm"], h, c, state=st)
                    x = x + h
                    hidden.append(x[0].float().clone())
            logits = apply_lm_head(params["embed"], _norm_apply(c, params["final_norm"], x))
        return logits[0, -1].float(), hidden

    bf16 = serving_params(masters, cfg, device)
    cfg32 = cfg.replace(dtype="float32")
    l1, h1 = step(bf16, cfg, 1)
    l4, h4 = step(bf16, cfg, cs.SLOTS)
    l32, h32 = step(serving_params(masters, cfg32, device), cfg32, 1)

    def rel(a, b):
        return float((a - b).abs().max() / b.pow(2).mean().sqrt())

    for j in range(0, len(h1), 4):
        print(f"[probe] after block {j}: batch 1 vs {cs.SLOTS} {rel(h1[j], h4[j]):.4g}, "
              f"bf16 vs fp32 {rel(h1[j], h32[j]):.4g} (of the state's RMS)")
    print(f"[probe] decode logits: batch 1 vs {cs.SLOTS} {rel(l1, l4):.4g}, bf16 vs fp32 "
          f"{rel(l1, l32):.4g} (of the RMS)")
    w = bf16["periods"]["p0"]["mlstm"]["wq"]["w"][0]
    x = torch.randn((cs.SLOTS, w.shape[0]), device=device).to(torch.bfloat16)
    q = torch.randn((16, 1, 1024), device=device)
    C = torch.randn((16, 1024, 1024), device=device)
    print(f"[probe] bf16 GEMM (M={cs.SLOTS}, {tuple(w.shape)}) row 0 == M=1: "
          f"{torch.equal((x @ w)[:1], x[:1] @ w)}; fp32 bmm batches 0-3 of 16 == of 4: "
          f"{torch.equal(torch.bmm(q, C)[:4], torch.bmm(q[:4], C[:4]))}")


def launch_times(cfg):
    """Device ms of each of ``mlstm_chunk``'s two launches at the cell's
    prefill shape, over ten warm calls."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.kernels.testing import mlstm_inputs

    B, S, dh = cfg.n_heads, cs.MLSTM_PREFILL_S, 2 * cfg.d_model // cfg.n_heads
    q, k, v, i, f, _ = mlstm_inputs(B, S, dh, "unit", seed=cs.SEED + 11, device="cuda")
    mlstm_chunk(q, k, v, i, f)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            mlstm_chunk(q, k, v, i, f)
        torch.cuda.synchronize()
    return {name: ms / count for ms, count, key in cs.device_rows(torch, prof)
            for name in ("mlstm_scores_kernel", "mlstm_state_kernel") if name in key}


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_probe: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.XLSTM_ARCH)
    print(f"[probe] {cs.nvidia_smi()}")
    cs.phase_build()
    batch_divergence(cfg, torch.device("cuda", 0))
    for _ in range(2):
        print(json.dumps(cs.phase_xlstm_timing(torch, cfg, {}, {})))
        print(f"[probe] mlstm_chunk's two launches at S={cs.MLSTM_PREFILL_S}: "
              f"{launch_times(cfg)} ms each (warm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
