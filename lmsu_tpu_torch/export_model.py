"""Export a trained checkpoint as a self-contained serving artifact.

Counterpart of scripts/export_model.py for the PyTorch port. Wraps
Predictor.export() (lmsu_tpu_torch/inference.py): the frozen model, its
weights as constants, traced by torch.export and written with
torch.export.save, so serving needs only torch, the port's operators and
the artifact (inference.py::load_exported; `python -m lmsu_tpu_torch.serve
--artifact`). The model is built as the port's `serve` builds it
(serve.build_config: the sorted scatter, the fused blocks and, for the
weighted fusion, the fused gate), so the artifact runs the same kernels as
`serve --checkpoint`. It is tied to the torch version that wrote it.

Usage:
  python -m lmsu_tpu_torch.export_model --checkpoint run/best.ckpt \\
      --output student.pt2 [--batch-size 1] [--fusion-type weighted] \\
      [--fusion-channels 128] [--bf16] [--platforms cuda]

--checkpoint takes what `serve --checkpoint` takes: the JAX package's
flax .ckpt, a reference .pth or a port state dict. --platforms names the
one device the artifact is traced for and runs on: cpu, or cuda (gpu).
"""

from __future__ import annotations

import argparse
import os
import sys

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--fusion-type", default="weighted",
                   choices=["concat", "minimal", "weighted", "gated_sum"])
    p.add_argument("--fusion-channels", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-points", type=int, default=5000)
    p.add_argument("--bf16", action="store_true", help="bf16 activations")
    p.add_argument("--no-point-valid", action="store_true",
                   help="omit the point_valid mask input (only safe when "
                   "serving unpadded clouds)")
    p.add_argument("--platforms", nargs="+", default=None,
                   help="the device to trace for: cpu or cuda (gpu); default cuda")
    args = p.parse_args(argv)

    platforms = args.platforms or ["cuda"]
    unknown = [x for x in platforms if x not in _PLATFORMS]
    if unknown:
        sys.exit(f"ERROR: --platforms {' '.join(unknown)}: the port exports for cpu or "
                 f"cuda (gpu), not {', '.join(unknown)}")
    if len({_PLATFORMS[x] for x in platforms}) != 1:
        sys.exit("ERROR: a torch.export artifact runs on one device; name one platform")
    device = _PLATFORMS[platforms[0]]

    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.serve import build_config, load_predictor

    if not os.path.exists(args.checkpoint):
        sys.exit(f"ERROR: checkpoint {args.checkpoint!r} not found. Train one first, "
                 f"e.g.\n  python -m lmsu_tpu_torch.train_synthetic")
    pin_f32_precision()
    args.device, args.freeze_weights = device, True
    pred = load_predictor(args, build_config(args))
    pred.export(args.output, batch_size=args.batch_size, num_points=args.num_points,
                with_point_valid=not args.no_point_valid)
    size = os.path.getsize(args.output) / 1e6
    print(f"Wrote {args.output} ({size:.1f} MB, batch={args.batch_size}, "
          f"{args.fusion_type}/{args.fusion_channels}{', bf16' if args.bf16 else ''}, "
          f"{device})")


if __name__ == "__main__":
    main()
