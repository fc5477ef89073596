"""Image / ground-truth BEV / predicted BEV triptychs with per-sample IoU.

Counterpart of scripts/visualize_predictions.py (reference
visualize_predictions.py:11-228), in two parts:
  * compute_predictions: batched inference over the val split on the
    device, the argmax and its margin over the runner-up class there, and
    each sample's drivable-class IoU on the host (numpy only);
  * render_figures: one matplotlib figure a sample (camera image, ground
    truth, prediction annotated with its IoU), imported when drawing.
main runs both; without matplotlib it raises before any inference, naming
it (the card's machine has none: chip_smoke.py drives the compute part
there).

Usage:
  python -m lmsu_tpu_torch.visualize_predictions --checkpoint <run>/best.pth \\
      [--device cuda] [--fusion-type concat] [--num-samples 8] [--batch-size 4] \\
      [--output-root torch_runs] [--output-dir DIR]

The checkpoint is a torch file of the port's trainers or a JAX-package flax
checkpoint (told by content); defaults sit under --output-root
(torch_runs/checkpoints/fusion_ablation_concat/best.pth, figures in
torch_runs/visualizations/). Raises without a GPU unless given --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

from lmsu_tpu_torch.common import (FUSION_CHANNELS, FUSION_TYPES, add_output_root_arg,
                                   import_pyplot)
from lmsu_tpu_torch.config import DataConfig, ModelConfig


def compute_iou_per_sample(pred: np.ndarray, gt: np.ndarray, cls: int = 1) -> float:
    """Drivable-class IoU for one sample (reference:
    visualize_predictions.py:84-94); NaN when the class is in neither."""
    p, g = pred == cls, gt == cls
    union = np.logical_or(p, g).sum()
    if union == 0:
        return float("nan")
    return float(np.logical_and(p, g).sum() / union)


def compute_predictions(predictor, loader, num_samples: int) -> Dict[str, np.ndarray]:
    """The first num_samples real samples (sample_mask) of `loader`, run
    through `predictor` a batch at a time: image [n, H, W, 3], segmentation
    and pred [n, h, w], margin [n, h, w] (the top logit less the runner-up,
    float32) and iou [n] (compute_iou_per_sample)."""
    keep = {k: [] for k in ("image", "segmentation", "pred", "margin")}
    for batch in loader:
        logits = predictor(batch["image"], batch["points"], batch.get("point_valid"))
        top2 = logits.float().topk(2, dim=-1).values
        pred = logits.argmax(dim=-1).cpu().numpy()
        margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        for b in range(len(pred)):
            if not batch["sample_mask"][b] or len(keep["pred"]) >= num_samples:
                continue
            for k, v in (("image", batch["image"][b]), ("segmentation", batch["segmentation"][b]),
                         ("pred", pred[b]), ("margin", margin[b])):
                keep[k].append(np.asarray(v))
        if len(keep["pred"]) >= num_samples:
            break
    out = {k: np.stack(v) for k, v in keep.items()}
    out["iou"] = np.asarray([compute_iou_per_sample(p, g) for p, g in
                             zip(out["pred"], out["segmentation"])], np.float64)
    return out


def render_figures(samples: Dict[str, np.ndarray], output_dir: str) -> int:
    """One PNG a sample in output_dir (sample_###.png); returns the count."""
    plt = import_pyplot()
    os.makedirs(output_dir, exist_ok=True)
    for i, (img, gt, pred, iou) in enumerate(zip(samples["image"], samples["segmentation"],
                                                 samples["pred"], samples["iou"])):
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(img)
        axes[0].set_title("Camera")
        axes[1].imshow(gt, cmap="viridis", vmin=0, vmax=1)
        axes[1].set_title("GT BEV (drivable)")
        axes[2].imshow(pred, cmap="viridis", vmin=0, vmax=1)
        axes[2].set_title(f"Predicted (IoU {iou:.3f})")
        for ax in axes:
            ax.axis("off")
        fig.savefig(os.path.join(output_dir, f"sample_{i:03d}.png"), dpi=100,
                    bbox_inches="tight")
        plt.close(fig)
    return len(samples["pred"])


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    add_output_root_arg(p)
    p.add_argument("--checkpoint", default=None,
                   help="default <output-root>/checkpoints/fusion_ablation_concat/best.pth")
    p.add_argument("--fusion-type", default="concat", choices=list(FUSION_TYPES))
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--dataset", default="synthetic", choices=["pandaset", "synthetic"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--num-samples", type=int, default=8)
    p.add_argument("--output-dir", default=None,
                   help="default <output-root>/visualizations")
    p.add_argument("--batch-size", type=int, default=4)
    return p


def main(argv=None):
    from lmsu_tpu_torch.data import create_datasets, make_loader
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.inference import Predictor, pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    import_pyplot()  # fail before any inference when figures cannot be drawn
    checkpoint = args.checkpoint or os.path.join(args.output_root, "checkpoints",
                                                 "fusion_ablation_concat", "best.pth")
    output_dir = args.output_dir or os.path.join(args.output_root, "visualizations")
    mcfg = ModelConfig(num_classes=args.num_classes, fusion_type=args.fusion_type,
                       fusion_out_channels=FUSION_CHANNELS[args.fusion_type])
    dcfg = DataConfig(dataset=args.dataset, root=args.data_root or DataConfig.root,
                      batch_size=args.batch_size)
    if not os.path.exists(checkpoint):
        # Checkpoints are not committed; the default path exists only after a
        # local training run.
        sys.exit(f"ERROR: checkpoint {checkpoint!r} not found. Train one first, e.g.\n"
                 f"  python -m lmsu_tpu_torch.train_synthetic --epochs 5 --save-dir "
                 f"{os.path.join(args.output_root, 'checkpoints', 'synthetic_concat')}\n"
                 f"then pass --checkpoint at its best.pth (or any run's best.pth / "
                 f"latest.pth).")
    predictor = Predictor(mcfg, load_weights(checkpoint, mcfg), device=args.device)
    print(f"Loaded {checkpoint}")
    _, val_ds = create_datasets(dcfg)
    loader = make_loader(val_ds, args.batch_size, shuffle=False)
    samples = compute_predictions(predictor, loader, args.num_samples)
    done = render_figures(samples, output_dir)
    valid = [i for i in samples["iou"] if not np.isnan(i)]
    print(f"Wrote {done} figures to {output_dir}/ — mean drivable IoU {np.mean(valid):.4f}"
          if valid else f"Wrote {done} figures to {output_dir}/")
    return samples


if __name__ == "__main__":
    main()
