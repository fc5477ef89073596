"""Input-pipeline benchmark: real per-frame decode feeding the card.

Counterpart of scripts/bench_input_pipeline.py. Fabricates PandaSet scenes
on disk at realistic raw sizes (1920x1080 q85 JPEGs, ~100k-point pandas
pickles: the decode cost the synthetic benchmarks never pay), then trains
with the port's loader stack and reports the input-stall fraction
StallMeter measures per epoch and the end-to-end frames/s. --decode-only
times the host decode alone (no model, no device).

Writing and reading the raw tree needs PIL and pandas; where they are
missing fabricate_scenes raises, naming them. The card's machine is not
known to have them: there, dress_rehearsal's packed and on-device modes run
from numpy-made frames (`numpy_frame_datasets`), which need neither.

Usage:
  python -m lmsu_tpu_torch.bench_input_pipeline [--device cuda] [--frames 96] \\
      [--batch-size 32] [--num-workers N] [--epochs 2] [--root DIR] [--decode-only] \\
      [--output-root torch_runs] [--out FILE]

Writes <output-root>/docs/input_pipeline_bench.json (--out), with `device`:
the card's name and power limit, or "cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from lmsu_tpu_torch.common import add_output_root_arg, device_label

FRAMES_PER_SCENE = 16


def _raw_tree_modules():
    """(pandas, PIL.Image), or a RuntimeError naming whichever is missing."""
    try:
        import pandas as pd
        from PIL import Image
    except ImportError as e:
        missing = [m for m in ("PIL", "pandas") if _missing(m)]
        raise RuntimeError(
            f"fabricating a raw PandaSet tree (JPEGs and pickles) needs "
            f"{' and '.join(missing) or 'PIL and pandas'}, not installed here; run where "
            f"they are, or use numpy-made frames (numpy_frame_datasets)") from e
    return pd, Image


def _missing(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is None


def fabricate_scenes(root: str, n_frames: int, points_per_frame: int, seed: int = 0) -> None:
    """A PandaSet tree under `root`: scenes of 16 frames, each a textured
    1920x1080 JPEG (q85), a cloud of `points_per_frame` points over +-80 m
    and its semseg class ids (0-13), as pandas pickles."""
    pd, Image = _raw_tree_modules()
    rng = np.random.default_rng(seed)
    for s in range((n_frames + FRAMES_PER_SCENE - 1) // FRAMES_PER_SCENE):
        sid = f"{s:03d}"
        cam = os.path.join(root, sid, "camera", "front_camera")
        lid = os.path.join(root, sid, "lidar")
        seg = os.path.join(root, sid, "annotations", "semseg")
        for d in (cam, lid, seg):
            os.makedirs(d, exist_ok=True)
        for f in range(min(FRAMES_PER_SCENE, n_frames - s * FRAMES_PER_SCENE)):
            fid = f"{f:02d}"
            # Textured image so the JPEG decode cost is realistic (flat
            # images compress to nothing and decode instantly).
            img = rng.integers(0, 255, (1080, 1920, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(cam, f"{fid}.jpg"), quality=85)
            n = points_per_frame
            pd.DataFrame({
                "x": rng.uniform(-80, 80, n).astype(np.float32),
                "y": rng.uniform(-80, 80, n).astype(np.float32),
                "z": rng.uniform(-5, 3, n).astype(np.float32),
                "i": rng.uniform(0, 1, n).astype(np.float32),
            }).to_pickle(os.path.join(lid, f"{fid}.pkl"))
            pd.DataFrame({"class": rng.integers(0, 14, n).astype(np.int64)}).to_pickle(
                os.path.join(seg, f"{fid}.pkl"))


class NumpyFrames:
    """Decoded PandaSet samples of numpy-made frames, frame by frame: the
    arrays fabricate_scenes writes (an image at the decoded size, a cloud
    over +-80 m, class ids 0-13, each frame's own seed) through
    data/pandaset.py::decode_frame, as PandaSetDataset decodes a raw frame
    after its JPEG and pickles are read. Needs neither PIL nor pandas."""

    def __init__(self, frames, points_per_frame: int, data_cfg, seed: int = 0):
        self.frames = list(frames)  # (scene, frame) ids
        self.points = points_per_frame
        self.cfg = data_cfg
        self.seed = seed

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int):
        from lmsu_tpu_torch.data.pandaset import decode_frame
        scene, frame = self.frames[idx]
        rng = np.random.default_rng([self.seed, int(scene), frame])
        h, w = self.cfg.image_size
        n = self.points
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        pts = np.stack([rng.uniform(-80, 80, n), rng.uniform(-80, 80, n),
                        rng.uniform(-5, 3, n), rng.uniform(0, 1, n)], 1).astype(np.float32)
        ids = rng.integers(0, 14, n).astype(np.int64)
        c = self.cfg
        s = decode_frame(img, pts, ids, grid_size=c.grid_size, max_points=c.max_points,
                         pc_range=c.pc_range, seed=0, index=idx,
                         pad_points_are_valid=c.pad_points_are_valid)
        s["sample_token"] = f"{scene}_{frame:02d}"
        return s


def numpy_frame_datasets(n_frames: int, points_per_frame: int, data_cfg, seed: int = 0):
    """(train, val) NumpyFrames of `n_frames` frames in scenes of 16, split
    by scene as a fabricated tree of the same size is
    (data/pandaset.py::split_scenes at data_cfg.train_fraction)."""
    from lmsu_tpu_torch.data.pandaset import split_scenes
    scenes = [f"{s:03d}" for s in range((n_frames + FRAMES_PER_SCENE - 1) // FRAMES_PER_SCENE)]
    train_ids, val_ids = split_scenes(scenes, data_cfg.train_fraction)

    def frames(ids):
        return [(sid, f) for sid in ids
                for f in range(min(FRAMES_PER_SCENE, n_frames - int(sid) * FRAMES_PER_SCENE))]
    return tuple(NumpyFrames(frames(ids), points_per_frame, data_cfg, seed)
                 for ids in (train_ids, val_ids))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    add_output_root_arg(ap)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="reuse a fabricated tree instead of building one")
    ap.add_argument("--decode-only", action="store_true",
                    help="measure pure host decode throughput (no model, no device): "
                    "iterate the Batcher and time it")
    ap.add_argument("--out", default=None,
                    help="default <output-root>/docs/input_pipeline_bench.json")
    return ap


def main(argv=None) -> dict:
    import torch

    from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
    from lmsu_tpu_torch.data import create_pandaset_datasets, make_loader
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    dev = resolve_device(args.device)
    pin_f32_precision()

    root = args.root
    if root is None:
        root = tempfile.mkdtemp(prefix="pandaset_bench_")
        t0 = time.perf_counter()
        fabricate_scenes(root, args.frames, args.points)
        print(f"fabricated {args.frames} frames ({args.points} pts) under {root} in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    result = {"device": device_label(dev), "frames": args.frames, "points": args.points,
              "batch_size": args.batch_size, "num_workers": args.num_workers, "epochs": []}
    if args.decode_only:
        dcfg = DataConfig(dataset="pandaset", root=root, batch_size=args.batch_size,
                          num_workers=args.num_workers)
        train_ds, _ = create_pandaset_datasets(dcfg)
        if len(train_ds) == 0:
            sys.exit("train split is empty — the scene split needs >=2 scenes "
                     "(use --frames >= 32)")
        loader = make_loader(train_ds, args.batch_size, shuffle=True,
                             decode_workers=args.num_workers)
        result["device"] = "host (decode only)"
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            t0, n = time.perf_counter(), 0
            for batch in loader:
                n += int(batch["sample_mask"].sum())
            dt = time.perf_counter() - t0
            result["epochs"].append({"epoch": epoch + 1, "wall_s": round(dt, 3),
                                     "frames_per_sec": round(n / dt, 1), "stall_frac": None,
                                     "ms_per_frame": round(dt / n * 1e3, 3)})
            print(f"epoch {epoch}: decode-only {n / dt:.1f} frames/s "
                  f"({dt / n * 1e3:.1f} ms/frame, workers={args.num_workers})", file=sys.stderr)
    else:
        from lmsu_tpu_torch.training import Trainer
        cfg = ExperimentConfig(
            model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                              compute_dtype=torch.bfloat16 if dev.type == "cuda"
                              else torch.float32),
            data=DataConfig(dataset="pandaset", root=root, batch_size=args.batch_size,
                            num_workers=args.num_workers),
            train=TrainConfig(num_epochs=args.epochs, class_weights=(0.4, 3.5),
                              save_dir=tempfile.mkdtemp(prefix="lmsu_ipbench_")))
        train_ds, val_ds = create_pandaset_datasets(cfg.data)
        n_train = len(train_ds)
        trainer = Trainer(cfg,
                          make_loader(train_ds, cfg.data.batch_size, shuffle=True,
                                      decode_workers=args.num_workers),
                          make_loader(val_ds, cfg.data.batch_size, shuffle=False,
                                      decode_workers=args.num_workers),
                          device=dev)
        for epoch in range(args.epochs):
            trainer.train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            loss, _ = trainer.train_epoch()
            dt = time.perf_counter() - t0
            result["epochs"].append({"epoch": epoch + 1, "wall_s": round(dt, 3),
                                     "frames_per_sec": round(n_train / dt, 1),
                                     "stall_frac": round(trainer.last_host_stall_frac, 4),
                                     "loss": float(loss)})
            print(f"epoch {epoch}: {dt:.1f}s  {n_train / dt:.1f} frames/s end-to-end (real "
                  f"decode, workers={args.num_workers})  input stall "
                  f"{trainer.last_host_stall_frac * 100:.0f}%  loss {loss:.4f}", file=sys.stderr)
    print(f"done; scenes left at {root}", file=sys.stderr)
    out = args.out or os.path.join(args.output_root, "docs", "input_pipeline_bench.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
