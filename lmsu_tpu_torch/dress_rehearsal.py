"""PandaSet-scale feeding dress rehearsal on the card.

Counterpart of scripts/dress_rehearsal.py. Fabricates a PandaSet tree at
real raw sizes (1920x1080 JPEG q85, 100k-point pickles; reference scale =
1,920 train + 480 val frames at --frames 2400), then trains the production
cached-teacher KD configuration for several epochs under each feeding mode
and measures the input-stall fraction and the end-to-end epoch time:

  raw     per-epoch JPEG / pickle decode (the reference's behaviour)
  cache   DataConfig.decoded_cache: epoch 1 decodes once into host memory,
          later epochs read it
  packed  pre-decoded packs (data/packed.py, written once here as
          prepare_dataset writes them): almost no decode at train time
  onchip  TrainConfig.onchip_epoch over the packs: the train and val sets
          go to the device once and every epoch runs there
          (--onchip-contiguous by default)

All modes run in one process. On the card the model computes in bf16 with
the sorted scatter (K1, K5); --tiny runs narrow frames and model on the CPU.

--numpy-frames (the port's) makes the frames in numpy instead of writing
and reading JPEGs and pickles (bench_input_pipeline.py::
numpy_frame_datasets, decoded by data/pandaset.py::decode_frame), so the
packed and onchip modes run without PIL and pandas; raw and cache need the
raw tree and are refused with it.

Usage:
  python -m lmsu_tpu_torch.dress_rehearsal --frames 2400 --epochs 3 [--device cuda] \\
      [--root DIR] [--modes raw,cache,packed,onchip] [--numpy-frames] [--tiny] \\
      [--cache-hbm-gb 8] [--taps post_fusion] [--output-root torch_runs] [--out FILE]

Writes <output-root>/docs/dress_rehearsal.json (--out), with `device`: the
card's name and power limit, or "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from lmsu_tpu_torch.common import add_output_root_arg, device_label

MODES = ("raw", "cache", "packed", "onchip")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    add_output_root_arg(ap)
    ap.add_argument("--frames", type=int, default=2400,
                    help="total fabricated frames (80/20 scene split -> reference scale "
                    "at 2400)")
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--scan-steps", type=int, default=8)
    ap.add_argument("--root", default=None, help="reuse a fabricated tree (skips fabrication)")
    ap.add_argument("--modes", default="raw,cache,packed,onchip",
                    help="feeding modes, comma-separated, of " + ", ".join(MODES))
    ap.add_argument("--onchip-contiguous", action="store_true", default=True)
    ap.add_argument("--no-onchip-contiguous", dest="onchip_contiguous", action="store_false")
    ap.add_argument("--cache-hbm-gb", type=float, default=8.0)
    ap.add_argument("--taps", default="post_fusion",
                    help="comma list of KD feature taps; post_fusion alone keeps the "
                    "teacher cache of 1,920 frames at ~3.9 GB on the device")
    ap.add_argument("--tiny", action="store_true",
                    help="small frames and model for CPU smoke testing")
    ap.add_argument("--numpy-frames", action="store_true",
                    help="numpy-made frames instead of a raw tree (packed and onchip "
                    "modes only; needs neither PIL nor pandas)")
    ap.add_argument("--out", default=None, help="default <output-root>/docs/dress_rehearsal.json")
    return ap


def main(argv=None) -> dict:
    import torch

    from lmsu_tpu_torch.bench_input_pipeline import fabricate_scenes, numpy_frame_datasets
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig)
    from lmsu_tpu_torch.data import create_datasets, make_loader, write_pack
    from lmsu_tpu_torch.data.rasterize import make_point_sorter
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    from lmsu_tpu_torch.prepare_dataset import _PrefetchedView
    from lmsu_tpu_torch.training import DistillationTrainer

    args = make_parser().parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"unknown mode {unknown[0]!r}")
    if args.numpy_frames and {"raw", "cache"} & set(modes):
        raise SystemExit("--numpy-frames makes no raw tree: the raw and cache modes need one "
                         "(and PIL and pandas to write and read it)")
    dev = resolve_device(args.device)
    pin_f32_precision()
    on_card = dev.type == "cuda"
    points = args.points if not args.tiny else 2000

    if args.tiny:
        model = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
                            camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),
                            lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                     grid_size=(8, 8)))
        image_size, grid, max_points = (32, 32), (8, 8), 512
    else:
        model = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                            compute_dtype=torch.bfloat16 if on_card else torch.float32)
        image_size, grid, max_points = (256, 256), (64, 64), 5000
        if on_card:
            model = model.replace(lidar=dataclasses.replace(model.lidar,
                                                            scatter_impl="sorted_pallas"))

    root = args.root
    if root is None:
        root = tempfile.mkdtemp(prefix="pandaset_dress_")
        if not args.numpy_frames:
            t0 = time.perf_counter()
            fabricate_scenes(root, args.frames, points)
            print(f"fabricated {args.frames} frames under {root} in "
                  f"{time.perf_counter() - t0:.0f}s", file=sys.stderr)

    base_data = DataConfig(dataset="pandaset", root=root, image_size=image_size,
                           grid_size=grid, max_points=max_points,
                           batch_size=args.batch_size, num_workers=args.num_workers)

    # Pre-decode pack (timed once; amortised over every later epoch and run).
    pack_dir = root.rstrip("/") + "_pack"
    pack_s = None
    if {"packed", "onchip"} & set(modes) and \
            not os.path.exists(os.path.join(pack_dir, "train", "meta.json")):
        train_ds, val_ds = (numpy_frame_datasets(args.frames, points, base_data)
                            if args.numpy_frames else create_datasets(base_data))
        t0 = time.perf_counter()
        for split, ds in (("train", train_ds), ("val", val_ds)):
            view = _PrefetchedView(ds, args.num_workers)
            try:
                write_pack(view, os.path.join(pack_dir, split))
            finally:
                view.close()
        pack_s = round(time.perf_counter() - t0, 1)
        print(f"packed {len(train_ds)}+{len(val_ds)} samples in {pack_s}s -> {pack_dir}",
              file=sys.stderr)

    transform = None
    if model.lidar.scatter_impl == "sorted_pallas":
        transform = make_point_sorter(model.lidar.grid_size, model.lidar.point_cloud_range)

    results = {}
    for mode in modes:
        tr_kw = {}
        if mode == "raw":
            data = base_data
        elif mode == "cache":
            data = dataclasses.replace(base_data, decoded_cache=True)
        elif mode == "packed":
            data = dataclasses.replace(base_data, dataset="packed", root=pack_dir)
        else:  # onchip: the packs, every epoch on the device
            data = dataclasses.replace(base_data, dataset="packed", root=pack_dir)
            tr_kw = dict(onchip_epoch=True, scan_steps=1,
                         onchip_contiguous=args.onchip_contiguous)
        train_kw = dict(
            num_epochs=args.epochs, class_weights=(0.4, 3.5), scan_steps=args.scan_steps,
            save_dir=os.path.join(tempfile.gettempdir(), f"dress_{mode}"),
            kd=KDConfig(enabled=True, cache_teacher=True,
                        feature_taps=tuple(args.taps.split(",")),
                        cache_hbm_limit_bytes=int(args.cache_hbm_gb * (1 << 30))))
        train_kw.update(tr_kw)
        cfg = ExperimentConfig(model=model, data=data, train=TrainConfig(**train_kw))
        train_ds, val_ds = create_datasets(cfg.data)
        train_loader = make_loader(train_ds, cfg.data.batch_size, shuffle=True, seed=0,
                                   decode_workers=cfg.data.num_workers,
                                   sample_transform=transform)
        val_loader = make_loader(val_ds, cfg.data.batch_size, shuffle=False,
                                 decode_workers=cfg.data.num_workers,
                                 sample_transform=transform)
        print(f"[{mode}] {len(train_ds)} train / {len(val_ds)} val", file=sys.stderr)
        trainer = DistillationTrainer(cfg, train_loader, val_loader, device=dev)
        t0 = time.perf_counter()
        trainer.train_epoch()  # builds the teacher cache, then epoch 1
        epochs = [{"epoch": 1, "wall_s": round(time.perf_counter() - t0, 3),
                   "incl_teacher_cache_fill": True,
                   "stall_frac": round(trainer.last_host_stall_frac, 4)}]
        for e in range(1, args.epochs):
            train_loader.set_epoch(e)
            t0 = time.perf_counter()
            trainer.train_epoch()
            epochs.append({"epoch": e + 1, "wall_s": round(time.perf_counter() - t0, 3),
                           "stall_frac": round(trainer.last_host_stall_frac, 4)})
        n = len(train_ds)
        for row in epochs:
            row["frames_per_sec"] = round(n / row["wall_s"], 1)
        results[mode] = epochs
        print(f"[{mode}] " + "  ".join(f"ep{r['epoch']}: {r['wall_s']}s stall "
                                       f"{r['stall_frac']:.0%}" for r in epochs),
              file=sys.stderr)
        trainer.flush_checkpoints()

    out = {"frames": args.frames, "points_per_frame": points,
           "batch_size": args.batch_size, "num_workers": args.num_workers,
           "scan_steps": args.scan_steps, "tiny": args.tiny,
           "backend": "cuda" if on_card else "cpu", "device": device_label(dev),
           "frame_source": "numpy" if args.numpy_frames else "raw tree",
           "scatter_impl": model.lidar.scatter_impl,
           "pack_write_s": pack_s, "modes": results}
    path = args.out or os.path.join(args.output_root, "docs", "dress_rehearsal.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
