"""Measure Predictor(freeze_weights=True) against the module path.

Counterpart of scripts/bench_frozen_predictor.py. The frozen copy
(models/frozen.py) folds every eval BatchNorm into its conv once and each
fused block's parameters once, where the module path (the Predictor's
model) reads them at every forward. Both are timed per forward as K
data-dependent chained forwards run back to back on the device: each
input is images + mean(previous output) * 0 + eps, so no forward can be
skipped or reordered, and the host synchronises once, at the end; CUDA
events bracket the chain (on the CPU a host clock does). One forward's
CUDA-event time sits beside them.

On the card the model is the serving cell's: weighted/128 with the kernel
opt-ins (scatter_impl sorted_pallas, the fused gate, fused_inference: K1,
K2, K3), bf16 unless --fp32. The BatchNorm statistics are moved off
identity (+0.01) so the fold folds something. The points are sorted by
cell once on the host, as Predictor.__call__ would.

Usage:
  python -m lmsu_tpu_torch.bench_frozen_predictor [--device cuda] [--tiny] \\
      [--iters 20] [--batches 1 32] [--fp32] [--output-root torch_runs] [--out FILE]

Prints the table and writes <output-root>/docs/frozen_predictor_bench.json
(--out), with `device`: the card's name and power limit, or "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from lmsu_tpu_torch.common import add_output_root_arg, device_label


def bench_shapes(tiny: bool):
    """(image_hw, num_points, label_hw) for the bench inputs (the root
    bench.py's shapes)."""
    return (64, 512, 16) if tiny else (256, 5000, 64)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain_forwards(forward, images, points, iters: int, eps: float, point_valid=None):
    """K chained forwards: each input is images + mean(previous output) * 0
    + eps. Returns the last output (nothing is synchronised)."""
    x = torch.zeros((), device=images.device, dtype=images.dtype)
    out = None
    for _ in range(iters):
        out = forward(images + x * 0.0 + eps, points, point_valid)
        x = out.float().mean().to(images.dtype)
    return out


def chain_time_eval(forward, images, points, iters: int, point_valid=None):
    """(ms per forward, the last output) of `iters` chained forwards
    (chain_forwards, eps 1e-6) after one warm-up chain (eps 0), timed with
    CUDA events on a CUDA device, with the host clock elsewhere."""
    dev = images.device
    chain_forwards(forward, images, points, iters, 0.0, point_valid)
    _sync(dev)
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = chain_forwards(forward, images, points, iters, 1e-6, point_valid)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    out = chain_forwards(forward, images, points, iters, 1e-6, point_valid)
    return (time.perf_counter() - t0) / iters * 1e3, out


def one_forward_ms(forward, images, points, point_valid=None, reps: int = 10) -> float:
    """The median time of one forward: CUDA events around each on a CUDA
    device, the host clock elsewhere."""
    dev = images.device
    times = []
    for _ in range(reps):
        _sync(dev)
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            forward(images, points, point_valid)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            forward(images, points, point_valid)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bench_config(tiny: bool, on_card: bool, fp32: bool):
    """The bench's ModelConfig: weighted/128 (--tiny: narrow widths), with
    the serving opt-ins on the card, bf16 there unless fp32."""
    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    dtype = torch.bfloat16 if (on_card and not fp32) else torch.float32
    if tiny:
        cfg = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
                          camera_fpn_channels=16, compute_dtype=dtype,
                          camera=CameraEncoderConfig(base_channels=8),
                          lidar=LidarEncoderConfig(feature_dim=32, mlp_dims=(16, 32),
                                                   grid_size=(16, 16)))
    else:
        cfg = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                          compute_dtype=dtype)
    if on_card:
        cfg = cfg.replace(use_pallas_fusion=True,
                          camera=dataclasses.replace(cfg.camera, fused_inference=True),
                          lidar=dataclasses.replace(cfg.lidar, scatter_impl="sorted_pallas"))
    return cfg


def bench_state(cfg, seed: int = 0):
    """Seed-drawn weights with every 1-D tensor moved by 0.01 (BatchNorm
    statistics and affine terms off identity, as the script does)."""
    from lmsu_tpu_torch.models import create_model
    sd = create_model(cfg, seed=seed).state_dict()
    return {k: v + 0.01 if v.dim() == 1 and v.is_floating_point() else v
            for k, v in sd.items()}


def bench_inputs(pred, rng, batch: int, img_hw: int, n_pts: int):
    """(images, points, point_valid) on the Predictor's device: float images
    in [0, 1], points N(0, 30) sorted by cell where the scatter wants it."""
    images = rng.uniform(0, 1, (batch, img_hw, img_hw, 3)).astype(np.float32)
    points = rng.normal(0, 30, (batch, n_pts, 4)).astype(np.float32)
    points, pv = pred._maybe_sort(points, None)
    dev = pred.device
    return (torch.from_numpy(images).to(dev), torch.from_numpy(np.asarray(points)).to(dev),
            None if pv is None else torch.from_numpy(np.asarray(pv)).to(dev))


def run_batch(runtime, frozen, rng, batch: int, img_hw: int, n_pts: int, iters: int) -> dict:
    """One row of the table: the module path's and the frozen copy's ms per
    chained forward, one module forward's time, and the chains' last
    outputs (`outputs`, for checks) with the inputs they ran on."""
    images, points, pv = bench_inputs(runtime, rng, batch, img_hw, n_pts)
    ms_runtime, out_runtime = chain_time_eval(runtime.forward_batch, images, points, iters, pv)
    ms_frozen, out_frozen = chain_time_eval(frozen.forward_batch, images, points, iters, pv)
    one = one_forward_ms(runtime.forward_batch, images, points, pv)
    return {"batch": batch, "runtime_ms": ms_runtime, "frozen_ms": ms_frozen,
            "one_forward_ms": one,
            "outputs": {"runtime": out_runtime, "frozen": out_frozen,
                        "inputs": (images + 1e-6, points, pv)}}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    add_output_root_arg(ap)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 32])
    ap.add_argument("--fp32", action="store_true", help="f32 on the card (default bf16)")
    ap.add_argument("--out", default=None,
                    help="default <output-root>/docs/frozen_predictor_bench.json")
    return ap


def main(argv=None) -> dict:
    from lmsu_tpu_torch.inference import Predictor, pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    dev = resolve_device(args.device)
    pin_f32_precision()
    on_card = dev.type == "cuda"
    img_hw, n_pts, _ = bench_shapes(args.tiny)
    cfg = bench_config(args.tiny, on_card, args.fp32)
    state = bench_state(cfg)
    runtime = Predictor(cfg, state, device=dev)
    frozen = Predictor(cfg, state, device=dev, freeze_weights=True)
    device = device_label(dev)
    rng = np.random.default_rng(7)
    print(f"device={device} img={img_hw} pts={n_pts} iters={args.iters}", file=sys.stderr)
    rows = []
    for b in args.batches:
        row = run_batch(runtime, frozen, rng, b, img_hw, n_pts, args.iters)
        row.pop("outputs")
        rows.append(row)
        mr, mf = row["runtime_ms"], row["frozen_ms"]
        print(f"B={b:3d}: runtime-vars {mr:7.3f} ms/fwd  frozen {mf:7.3f} ms/fwd  "
              f"delta {(mr - mf) / mr * 100:+.1f}%  one forward {row['one_forward_ms']:.3f} ms",
              flush=True)

    print("\n| B | runtime-vars ms | frozen ms | delta |")
    print("|---|---|---|---|")
    for r in rows:
        mr, mf = r["runtime_ms"], r["frozen_ms"]
        print(f"| {r['batch']} | {mr:.3f} | {mf:.3f} | {(mr - mf) / mr * 100:+.1f}% |")
    result = {"device": device, "dtype": str(cfg.compute_dtype).replace("torch.", ""),
              "iters": args.iters, "image": img_hw, "points": n_pts,
              "scatter_impl": cfg.lidar.scatter_impl, "rows": rows}
    out = args.out or os.path.join(args.output_root, "docs", "frozen_predictor_bench.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
