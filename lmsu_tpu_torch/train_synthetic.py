"""Quick end-to-end training on the synthetic dataset, on a CUDA card.

Counterpart of scripts/train_synthetic.py for the PyTorch port: synthetic
data -> the concat/256 model -> the 2-class CE train loop (class weights
0.4 / 3.5, 5 epochs) -> training_history.json and latest.pth / best.pth.

Usage:
  python -m lmsu_tpu_torch.train_synthetic [--device cuda] [--epochs 5] \\
      [--num-train 800 --num-val 200] [--batch-size 4] \\
      [--scatter-impl sorted_pallas] [--save-dir checkpoints/synthetic_concat] [--resume]

The flags are lmsu_tpu_torch/common.py's. It raises without a GPU unless
given --device cpu.
"""

from __future__ import annotations

import argparse

from lmsu_tpu_torch.common import (add_common_args, apply_overrides, build_loaders,
                                   maybe_resume)
from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig


def build_config(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="concat", fusion_out_channels=256),
        data=DataConfig(dataset="synthetic"),
        train=TrainConfig(num_epochs=5, class_weights=(0.4, 3.5),
                          save_dir="checkpoints/synthetic_concat"))
    return apply_overrides(cfg, args)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    return p


def main(argv=None) -> float:
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    from lmsu_tpu_torch.training import Trainer
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    cfg = build_config(args)
    train_loader, val_loader = build_loaders(cfg)
    trainer = Trainer(cfg, train_loader, val_loader, device=args.device)
    best = trainer.train(maybe_resume(trainer, cfg, args.resume))
    print(f"Best val mIoU: {best:.4f}")
    return best


if __name__ == "__main__":
    main()
