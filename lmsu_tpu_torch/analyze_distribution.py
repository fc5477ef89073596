"""Class distribution of a dataset's BEV labels and the class weights it
recommends (numpy only; no GPU needed).

Counterpart of scripts/analyze_distribution.py (reference
test_dataset_distribution.py:7-84 and verify_2class_distribution.py:6-34)
over the port's create_datasets: per-class pixel histograms of the train
and val splits, inverse-frequency weights normalized to mean 1, an
imbalance warning, and the train/val drift check. Its output is the JAX
script's, line for line.

Usage:
  python -m lmsu_tpu_torch.analyze_distribution [--dataset synthetic|pandaset] \\
      [--data-root data/pandaset] [--num-classes 2] [--max-samples 200]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from lmsu_tpu_torch.config import DataConfig
from lmsu_tpu_torch.data import create_datasets


def class_histogram(dataset, num_classes: int, max_samples: Optional[int] = None):
    """(pixel counts per class [num_classes], samples read) over the first
    max_samples samples; labels >= num_classes are counted apart and
    reported, never dropped silently."""
    counts = np.zeros(num_classes, np.int64)
    overflow = 0
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        seg = dataset[i]["segmentation"]
        full = np.bincount(seg[seg >= 0].ravel(), minlength=num_classes)
        counts += full[:num_classes]
        overflow += int(full[num_classes:].sum())
    if overflow:
        print(f"WARNING: {overflow:,} pixels carry labels >= {num_classes} and are "
              f"excluded — rerun with a larger --num-classes for a complete audit")
    return counts, n


def report(name: str, counts: np.ndarray) -> np.ndarray:
    """Print a split's histogram and recommended weights; returns its class
    frequencies."""
    total = counts.sum()
    freqs = counts / max(total, 1)
    print(f"\n{name}: {total:,} labeled pixels")
    for c, (n, f) in enumerate(zip(counts, freqs)):
        print(f"  class {c}: {n:>12,} ({100 * f:6.2f}%)")
    # Inverse frequency normalized to mean 1 (test_dataset_distribution.py:29-38).
    inv = 1.0 / np.maximum(freqs, 1e-8)
    weights = inv / inv.mean()
    print(f"  recommended class weights: {[round(float(w), 2) for w in weights]}")
    ratio = freqs.max() / max(freqs.min(), 1e-8)
    if ratio > 10:
        print(f"  WARNING: severe class imbalance ({ratio:.0f}:1)")
    return freqs


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="synthetic", choices=["pandaset", "synthetic"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--max-samples", type=int, default=200)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    dcfg = DataConfig(dataset=args.dataset, root=args.data_root or DataConfig.root)
    train_ds, val_ds = create_datasets(dcfg)
    tr_counts, tr_n = class_histogram(train_ds, args.num_classes, args.max_samples)
    va_counts, va_n = class_histogram(val_ds, args.num_classes, args.max_samples)
    tr_f = report(f"train ({tr_n} samples)", tr_counts)
    va_f = report(f"val ({va_n} samples)", va_counts)
    drift = np.abs(tr_f - va_f).max()
    print(f"\ntrain/val max class-frequency drift: {100 * drift:.2f}%")
    if drift > 0.05:
        print("WARNING: train/val distribution drift > 5%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
