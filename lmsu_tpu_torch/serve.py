"""Serve the model over HTTP with dynamic batching, on a CUDA card.

Counterpart of scripts/serve.py for the PyTorch port. The model is the
weighted/128 student unless --fusion-type and --fusion-channels say
otherwise, with the port's kernels on its path: the sorted-input BEV
scatter (points are cell-sorted on the request threads), the fused
InvertedResidual blocks and, for the weighted fusion, the fused gate.

Usage:
  python -m lmsu_tpu_torch.serve [--checkpoint model.pth | --seed 0] \\
      [--device cuda] [--fusion-type {concat,minimal,weighted,gated_sum}] \\
      [--fusion-channels 128] [--bf16] [--batch-size 8] [--max-delay-ms 2] [--port 8765]

--checkpoint takes a reference .pth (trainer checkpoint with 'model_state'
or a bare state dict) or a saved state dict of the port's model; without it
the weights are drawn from --seed (for smoke runs).

Client example (npz transport):
  import io, urllib.request, numpy as np
  buf = io.BytesIO(); np.savez(buf, image=img_u8, points=pts_f32)
  r = urllib.request.urlopen(urllib.request.Request(
      "http://127.0.0.1:8765/v1/predict?output=mask", data=buf.getvalue(),
      headers={"Content-Type": "application/x-npz"}))
  mask = np.load(io.BytesIO(r.read()))["mask"]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def build_config(args):
    from lmsu_tpu_torch.config import (CameraEncoderConfig, LidarEncoderConfig,
                                       ModelConfig)
    return ModelConfig(
        num_classes=args.num_classes, fusion_type=args.fusion_type,
        fusion_out_channels=args.fusion_channels, use_pallas_fusion=True,
        camera=CameraEncoderConfig(fused_inference=True),
        lidar=LidarEncoderConfig(scatter_impl="sorted_pallas"),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)


def build_engine(args):
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.serving import ServingEngine
    cfg = build_config(args)
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            sys.exit(f"ERROR: checkpoint {args.checkpoint!r} not found")
        pred = Predictor.from_torch_checkpoint(args.checkpoint, cfg, device=args.device)
    else:
        pred = Predictor(cfg, device=args.device, seed=args.seed)
    return ServingEngine.from_predictor(
        pred, batch_size=args.batch_size, batch_sizes=args.batch_sizes,
        image_size=tuple(args.image_size), num_points=args.num_points,
        max_delay_ms=args.max_delay_ms, max_queue=args.max_queue)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--checkpoint", help="reference .pth or port state dict")
    src.add_argument("--seed", type=int, default=0,
                     help="random-init seed when no --checkpoint is given")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--fusion-type", default="weighted",
                   choices=["concat", "minimal", "weighted", "gated_sum"])
    p.add_argument("--fusion-channels", type=int, default=128)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch-size", type=int, default=8,
                   help="batch size; requests are micro-batched up to this")
    p.add_argument("--batch-sizes", type=int, nargs="+", default=None, metavar="B",
                   help="batch-size ladder, e.g. 1 8 32: each window is padded "
                   "to the smallest rung that fits. Overrides --batch-size")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="batching window (max extra latency per request)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admitted-but-undispatched request bound; at the bound "
                   "requests get 503 (load shedding). 0 = unbounded")
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--num-points", type=int, default=5000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--verbose", action="store_true", help="per-request access log")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.serving import make_server

    pin_f32_precision()

    engine = build_engine(args)
    print("Warming up (kernel build, one forward per batch size)...", flush=True)
    engine.warmup()
    server = make_server(engine, args.host, args.port, verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"Serving on http://{host}:{port}  "
          f"(batch={engine.batch_size}, window={args.max_delay_ms} ms, "
          f"device={args.device})\n"
          f"  POST /v1/predict[?output=mask]   GET /v1/stats   GET /healthz")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()
        print("\nFinal stats:", engine.stats())


if __name__ == "__main__":
    main()
