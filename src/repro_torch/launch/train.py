"""Training launcher: an argparse adapter over the Trainer (the
reference's ``launch/train.py`` on one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm2-1.7b \\
      --reduced --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/run1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
      --reduced --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --reduced --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \\
      --reduced --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm2-1.7b \\
      --reduced --steps 4 --precision mixed --microbatches 2 --device cpu

The port trains the dense_lm, ssm_lm (xlstm), hybrid (jamba) and moe_lm
(deepseek-v2/v3) families; the log line carries the MoE's load-balance
loss (``aux``) beside the cross-entropy, and under ``--precision mixed``
the loss scale; a loss-scaled run ends with the scale and its count of
overflow-skipped steps.

Without ``--device`` the run is on the CUDA device, and raises when
there is none. ``--dump-spec`` prints the resolved RunSpec JSON (the
reference's format) and exits.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from repro_torch.api import (
    CheckpointSpec,
    ModelSpec,
    PrecisionSpec,
    RunSpec,
    Trainer,
    TrainSpec,
    log_metrics,
)
from repro_torch.core.tree import max_orthogonality_error


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm2-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--precision", choices=["legacy", "fp32", "bf16", "mixed"],
                    default="legacy",
                    help="legacy: compute in the config dtype over fp32 masters; "
                         "fp32: everything fp32; bf16: bf16 factors and compute; "
                         "mixed: fp32 masters, bf16 compute, dynamic loss scaling "
                         "with overflow skip")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split each batch into this many equal slices and "
                         "accumulate their gradients in fp32")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved RunSpec JSON and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap


def build_spec(args: argparse.Namespace) -> RunSpec:
    return RunSpec(
        model=ModelSpec(arch=args.arch, reduced=args.reduced),
        train=TrainSpec(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                        microbatches=args.microbatches, seed=args.seed),
        precision=PrecisionSpec(mode=args.precision),
        checkpoint=CheckpointSpec(directory=args.ckpt_dir, every=args.ckpt_every),
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    spec = build_spec(args)
    if args.dump_spec:
        print(spec.to_json(indent=2))
        return
    trainer = Trainer(spec, device=args.device, metrics_cb=log_metrics)
    state = trainer.fit()
    print("final ortho error:", float(max_orthogonality_error(state["params"])))
    if "loss_scale" in state:
        print(f"loss scale: {float(state['loss_scale']['scale']):.0f}  "
              f"overflow-skipped steps: {int(state['loss_scale']['skipped'])} "
              f"(loop saw {trainer.loop.overflow_steps})")


if __name__ == "__main__":
    main()
