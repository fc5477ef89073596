"""Fusion ablation sweep on a CUDA card: concat / minimal / weighted.

Counterpart of scripts/train_fusion_ablation.py (reference
train_with_fusion_ablation.py:69-135) for the PyTorch port: trains each
fusion variant of config.preset_fusion_ablation (2-class, weights
[0.4, 3.5], 20 epochs) into <run-prefix>_<type>/ and writes
fusion_ablation_results.json with the reference schema: per variant its
best val mIoU and its total and fusion parameter counts as formatted
strings. --kd distills each variant from its 2x-wide teacher instead.

Usage:
  python -m lmsu_tpu_torch.train_fusion_ablation [--device cuda] \\
      [--variants concat minimal weighted] [--kd [--teacher-checkpoint t.pth]] \\
      [--epochs 20] [--dataset synthetic --num-train 800 --num-val 200] \\
      [--scatter-impl sorted_pallas] \\
      [--output fusion_ablation_results.json] [--run-prefix checkpoints/fusion_ablation]

The other flags are lmsu_tpu_torch/common.py's; the data is the preset's,
the PandaSet tree under data/pandaset, unless --dataset (synthetic,
packed) and --data-root say otherwise. It raises without a GPU unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from lmsu_tpu_torch.common import add_common_args, apply_overrides, build_loaders
from lmsu_tpu_torch.config import KDConfig, preset_fusion_ablation
from lmsu_tpu_torch.models import get_architecture_summary

VARIANTS = ("concat", "minimal", "weighted")


def variant_config(fusion_type: str, args):
    cfg = apply_overrides(preset_fusion_ablation(fusion_type), args)
    if args.save_dir is None:  # per-variant run dirs unless overridden
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, save_dir=f"{args.run_prefix}_{fusion_type}"))
    if args.kd:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, kd=KDConfig(enabled=True, teacher_checkpoint=args.teacher_checkpoint)))
    return cfg


def train_variant(fusion_type: str, args) -> dict:
    from lmsu_tpu_torch.training import DistillationTrainer, Trainer
    cfg = variant_config(fusion_type, args)
    train_loader, val_loader = build_loaders(cfg)
    cls = DistillationTrainer if args.kd else Trainer
    trainer = cls(cfg, train_loader, val_loader, device=args.device)
    summary = get_architecture_summary(trainer.model)
    print(f"\n=== {fusion_type}: total {summary['total_params']} params, "
          f"fusion {summary['fusion_params']} ===")
    best = trainer.train()
    return {"miou": float(best), "total_params": summary["total_params"],
            "fusion_params": summary["fusion_params"]}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    p.add_argument("--kd", action="store_true",
                   help="distill each variant from a 2x-wide teacher")
    p.add_argument("--teacher-checkpoint", default=None)
    p.add_argument("--output", default="fusion_ablation_results.json")
    p.add_argument("--run-prefix", default="checkpoints/fusion_ablation",
                   help="per-variant run dirs become <prefix>_<type>")
    return p


def main(argv=None) -> dict:
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()

    results = {ft: train_variant(ft, args) for ft in args.variants}
    print("\n=== Fusion ablation results ===")
    print(f"{'variant':>10s} {'mIoU':>8s} {'params':>10s}")
    for ft, r in results.items():
        print(f"{ft:>10s} {r['miou']:8.4f} {r['total_params']:>10s}")
    best = max(results, key=lambda k: results[k]["miou"])
    print(f"Best fusion: {best} (mIoU {results[best]['miou']:.4f})")
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"Wrote {args.output}")
    return results


if __name__ == "__main__":
    main()
