"""Decode a dataset once into memory-mapped packs (offline; no GPU needed).

Counterpart of scripts/prepare_dataset.py for the PyTorch port: writes
<out>/train and <out>/val packs (data/packed.py) from a PandaSet tree or
the synthetic dataset. Training then reads them with `--dataset packed
--data-root <out>` and pays a few copies a sample instead of a JPEG and two
pickles. The packs are the JAX package's format: either package reads
what the other wrote.

Decode runs on --workers threads a window ahead of the writer (PIL's JPEG
decode, numpy and the native host ops release the GIL).

Usage:
  python -m lmsu_tpu_torch.prepare_dataset --dataset pandaset --root data/pandaset \\
      --out packs/pandaset [--image-size 256 256] [--grid-size 64 64] \\
      [--max-points 5000] [--workers 4]
"""

from __future__ import annotations

import argparse
import os
import time

from lmsu_tpu_torch.config import DataConfig
from lmsu_tpu_torch.data import create_datasets, write_pack


class _PrefetchedView:
    """Read-ahead view of a dataset: write_pack's sequential reads overlap
    the decode of the next 2 * workers samples."""

    def __init__(self, dataset, workers: int):
        self.dataset = dataset
        self.workers = workers
        self._pool = None
        self._futures = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if self.workers <= 1:
            return self.dataset[i]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.workers)
        for j in range(i, min(i + 2 * self.workers, len(self.dataset))):
            if j not in self._futures:
                self._futures[j] = self._pool.submit(self.dataset.__getitem__, j)
        fut = self._futures.pop(i, None)
        return fut.result() if fut is not None else self.dataset[i]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="pandaset", choices=["pandaset", "synthetic"])
    ap.add_argument("--root", default="data/pandaset",
                    help="the PandaSet tree (ignored for synthetic)")
    ap.add_argument("--out", required=True, help="pack output directory")
    ap.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--grid-size", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--max-points", type=int, default=5000)
    ap.add_argument("--train-fraction", type=float, default=0.8)
    ap.add_argument("--num-train", type=int, default=800, help="synthetic only")
    ap.add_argument("--num-val", type=int, default=200, help="synthetic only")
    ap.add_argument("--synthetic-difficulty", default="hard")
    ap.add_argument("--workers", type=int, default=2)
    return ap


def main(argv=None) -> dict:
    """Write both packs; returns {split: (samples, seconds)}."""
    args = make_parser().parse_args(argv)
    cfg = DataConfig(
        dataset=args.dataset, root=args.root, image_size=tuple(args.image_size),
        grid_size=tuple(args.grid_size), max_points=args.max_points,
        train_fraction=args.train_fraction, synthetic_num_train=args.num_train,
        synthetic_num_val=args.num_val, synthetic_difficulty=args.synthetic_difficulty)
    train_ds, val_ds = create_datasets(cfg, verbose=True)
    done = {}
    for split, ds in (("train", train_ds), ("val", val_ds)):
        out = os.path.join(args.out, split)
        view = _PrefetchedView(ds, args.workers)
        t0 = time.perf_counter()
        try:
            write_pack(view, out, verbose=True)
        finally:
            view.close()
        dt = time.perf_counter() - t0
        done[split] = (len(ds), dt)
        print(f"{split}: packed {len(ds)} samples -> {out} in {dt:.1f}s "
              f"({len(ds) / max(dt, 1e-9):.1f} samples/s)")
    print(f"train with: --dataset packed --data-root {args.out}")
    return done


if __name__ == "__main__":
    main()
