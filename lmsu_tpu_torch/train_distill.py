"""Teacher->student knowledge-distillation training on a CUDA card.

Counterpart of scripts/train_distill.py (with the build_loaders of
scripts/common.py) for the PyTorch port. Two phases:
  1. (optional, --train-teacher) train the 2x-wide teacher with CE;
  2. distill into the weighted-fusion student: CE + logit KL + feature
     matching on the camera_feat / lidar_feat / post_fusion taps.

Usage:
  python -m lmsu_tpu_torch.train_distill [--device cuda] [--epochs 20] \\
      [--batch-size 4] [--num-train 800 --num-val 200] [--difficulty easy] \\
      [--scatter-impl {xla,xla_fastbwd,sorted,pallas,sorted_pallas}] \\
      [--use-pallas-fusion] [--use-pallas-kd] \\
      [--bf16] [--teacher-checkpoint teacher.pth | --train-teacher] \\
      [--save-dir checkpoints/distill_student] [--resume]

The data is the synthetic dataset. --scatter-impl takes the JAX package's
five scatter-max algorithms (xla, xla_fastbwd, sorted, pallas,
sorted_pallas); with sorted_pallas the loaders sort each sample's points by
BEV cell (the sorted kernels' input contract), with the others the points
stay in their order. --use-pallas-fusion and --use-pallas-kd turn on the
fusion-gate and feature-MSE kernels (the JAX package's names). Checkpoints
are torch files (latest.pth, best.pth) in --save-dir beside
training_history.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from lmsu_tpu_torch.config import (DataConfig, ExperimentConfig, KDConfig,
                                   LidarEncoderConfig, ModelConfig, TrainConfig,
                                   teacher_config)


def build_configs(args):
    """(student ExperimentConfig, teacher ModelConfig). The teacher's width
    is anchored to the reference-size model, before any --width shrink."""
    kd = KDConfig(enabled=True, temperature=args.temperature, alpha_kl=args.alpha_kl,
                  beta_feature=args.beta_feature, teacher_width_mult=args.teacher_width,
                  teacher_checkpoint=args.teacher_checkpoint,
                  use_pallas=args.use_pallas_kd)
    model = ModelConfig(num_classes=2, fusion_type="weighted",
                        fusion_out_channels=args.fusion_channels,
                        use_pallas_fusion=args.use_pallas_fusion,
                        lidar=LidarEncoderConfig(scatter_impl=args.scatter_impl),
                        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    data = DataConfig(dataset=args.dataset)
    data_kw = {"batch_size": args.batch_size, "synthetic_num_train": args.num_train,
               "synthetic_num_val": args.num_val, "synthetic_difficulty": args.difficulty,
               "num_workers": args.num_workers}
    train_kw = {"num_epochs": args.epochs, "lr": args.lr, "save_dir": args.save_dir,
                "seed": args.seed, "grad_clip_norm": args.grad_clip_norm,
                "ema_decay": args.ema_decay}
    cfg = ExperimentConfig(
        model=model,
        data=dataclasses.replace(data, **{k: v for k, v in data_kw.items() if v is not None}),
        train=TrainConfig(class_weights=(0.4, 3.5), kd=kd,
                          **{k: v for k, v in train_kw.items() if v is not None}))
    tcfg_model = teacher_config(cfg.model, args.teacher_width)
    if args.width != 1.0:
        cfg = cfg.replace(model=teacher_config(cfg.model, args.width))
    return cfg, tcfg_model


def build_loaders(cfg: ExperimentConfig, verbose: bool = True):
    """Train/val loaders; the cell sort rides the decode workers when the
    sorted scatter is on (scripts/common.py::build_loaders)."""
    from lmsu_tpu_torch.data import create_datasets, make_loader
    from lmsu_tpu_torch.data.rasterize import make_point_sorter
    train_ds, val_ds = create_datasets(cfg.data, verbose=verbose)
    transform = None
    if cfg.model.lidar.scatter_impl == "sorted_pallas":
        transform = make_point_sorter(cfg.model.lidar.grid_size,
                                      cfg.model.lidar.point_cloud_range)
    train_loader = make_loader(train_ds, cfg.data.batch_size, shuffle=cfg.data.shuffle_train,
                               seed=cfg.train.seed, decode_workers=cfg.data.num_workers,
                               sample_transform=transform)
    val_loader = make_loader(val_ds, cfg.data.batch_size, shuffle=False,
                             decode_workers=cfg.data.num_workers, sample_transform=transform)
    if verbose:
        print(f"Dataset: {cfg.data.dataset} — {len(train_ds)} train / "
              f"{len(val_ds)} val samples")
    return train_loader, val_loader


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--save-dir", default="checkpoints/distill_student")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num-train", type=int, default=None, help="synthetic: #train samples")
    p.add_argument("--num-val", type=int, default=None)
    p.add_argument("--difficulty", default=None, choices=["easy", "hard"])
    p.add_argument("--num-workers", type=int, default=None,
                   help="per-sample decode threads in the input pipeline")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save-dir>/latest.pth if present")
    p.add_argument("--fusion-channels", type=int, default=128)
    p.add_argument("--scatter-impl", default="xla",
                   choices=["xla", "xla_fastbwd", "sorted", "pallas", "sorted_pallas"],
                   help="BEV scatter-max (LidarEncoderConfig.scatter_impl): 'xla' "
                   "scatter_reduce with autograd's backward; 'xla_fastbwd' the same "
                   "forward with the dense tie-splitting backward; 'sorted' sort + "
                   "segmented prefix max, dense backward; 'pallas' the unsorted "
                   "scatter-max kernel, dense backward; 'sorted_pallas' the "
                   "sorted-scatter kernels, and it also turns on the loaders' "
                   "by-cell point sort")
    p.add_argument("--use-pallas-fusion", action="store_true",
                   help="run the weighted-fusion gate through its kernel")
    p.add_argument("--use-pallas-kd", action="store_true",
                   help="run the feature-matching loss through its kernel")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute, f32 parameters")
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--teacher-checkpoint", default=None,
                   help="trained teacher (.pth from this trainer, or a state dict); "
                   "else a random teacher")
    p.add_argument("--train-teacher", action="store_true",
                   help="train the teacher first, then distill")
    p.add_argument("--teacher-epochs", type=int, default=None)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha-kl", type=float, default=0.5)
    p.add_argument("--beta-feature", type=float, default=0.5)
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--width", type=float, default=1.0, help="student width multiplier")
    return p


def main(argv=None) -> float:
    from lmsu_tpu_torch.inference import resolve_device
    from lmsu_tpu_torch.training import DistillationTrainer, Trainer
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    cfg, tcfg_model = build_configs(args)

    teacher_sd = None
    if args.train_teacher:
        tcfg = cfg.replace(model=tcfg_model, train=dataclasses.replace(
            cfg.train, kd=KDConfig(enabled=False),
            num_epochs=args.teacher_epochs or cfg.train.num_epochs,
            save_dir=cfg.train.save_dir + "_teacher"))
        print("=== Phase 1: training teacher ===")
        tl, vl = build_loaders(tcfg)
        t_trainer = Trainer(tcfg, tl, vl, device=args.device)
        print(f"Teacher best mIoU: {t_trainer.train():.4f}")
        teacher_sd = t_trainer.model.state_dict()

    print("=== Distilling student ===")
    train_loader, val_loader = build_loaders(cfg)
    trainer = DistillationTrainer(cfg, train_loader, val_loader, teacher_state_dict=teacher_sd,
                                  teacher_model_config=tcfg_model, device=args.device)
    start_epoch = 0
    latest = os.path.join(cfg.train.save_dir, "latest.pth")
    if args.resume and os.path.exists(latest):
        start_epoch = trainer.load_checkpoint(latest)
    best = trainer.train(start_epoch)
    print(f"Student best val mIoU: {best:.4f}")
    if trainer.last_loss_parts:
        print("Final loss parts:", trainer.last_loss_parts)
    return best


if __name__ == "__main__":
    main()
