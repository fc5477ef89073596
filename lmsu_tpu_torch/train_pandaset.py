"""The weighted 3-class PandaSet run on a CUDA card.

Counterpart of scripts/train_pandaset.py (reference train_pandaset.py:
79-163) for the PyTorch port: the concat/256 model with num_classes=3
trained on 2-class BEV labels with class weights [0.39, 2.61, 33.09] for 30
epochs into checkpoints/pandaset_weighted (config.preset_pandaset_weighted).
Three classes over 2-class labels is the reference's own quirk; the metrics
stay 2-class, so a pixel whose third logit wins is left out of the
confusion matrix. --num-classes overrides it when it matches the class
weights.

Usage:
  python -m lmsu_tpu_torch.train_pandaset [--device cuda] \\
      [--data-root data/pandaset] [--decoded-cache] [--num-workers 4] \\
      [--dataset packed --data-root packs/pandaset] [--epochs 30] \\
      [--scatter-impl sorted_pallas] [--save-dir checkpoints/pandaset_weighted] [--resume]

The other flags are lmsu_tpu_torch/common.py's. It raises without a GPU
unless given --device cpu.
"""

from __future__ import annotations

import argparse

from lmsu_tpu_torch.common import (add_common_args, apply_overrides, build_loaders,
                                   maybe_resume)
from lmsu_tpu_torch.config import ExperimentConfig, preset_pandaset_weighted
from lmsu_tpu_torch.models import get_architecture_summary


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--num-classes", type=int, default=3)
    return p


def build_config(args, parser: argparse.ArgumentParser) -> ExperimentConfig:
    """The preset with the common flags and --num-classes applied; a class
    count that does not match the preset's class weights is refused."""
    cfg = apply_overrides(preset_pandaset_weighted(), args)
    if args.num_classes != cfg.model.num_classes:
        if args.num_classes != len(cfg.train.class_weights):
            parser.error(
                f"--num-classes {args.num_classes} does not match the preset's "
                f"{len(cfg.train.class_weights)} class weights {cfg.train.class_weights}; "
                f"the loss would mis-weight classes. Adjust TrainConfig.class_weights "
                f"alongside it.")
        cfg = cfg.replace(model=cfg.model.replace(num_classes=args.num_classes))
    return cfg


def main(argv=None) -> float:
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    from lmsu_tpu_torch.training import Trainer
    parser = make_parser()
    args = parser.parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    cfg = build_config(args, parser)
    train_loader, val_loader = build_loaders(cfg)
    trainer = Trainer(cfg, train_loader, val_loader, device=args.device)
    print("Model architecture:")
    for k, v in get_architecture_summary(trainer.model).items():
        print(f"  {k}: {v}")
    best = trainer.train(maybe_resume(trainer, cfg, args.resume))
    print(f"Best val mIoU: {best:.4f}")
    return best


if __name__ == "__main__":
    main()
