"""Teacher->student knowledge-distillation training on a CUDA card.

Counterpart of scripts/train_distill.py for the PyTorch port. Two phases:
  1. (optional, --train-teacher) train the 2x-wide teacher with CE, or
     --num-teachers of them (seeds offset by 1000 each, save dirs
     <save-dir>_teacher, <save-dir>_teacher1, ...);
  2. distill into the student (weighted/128 unless --fusion-type and
     --fusion-channels say otherwise): CE + logit KL + feature matching on
     the camera_feat / lidar_feat / post_fusion taps, from one teacher or
     from the average of an ensemble.

Usage:
  python -m lmsu_tpu_torch.train_distill [--device cuda] [--epochs 20] \\
      [--batch-size 4] [--num-train 800 --num-val 200] [--difficulty easy] \\
      [--fusion-type {concat,minimal,weighted,gated_sum}] [--fusion-channels 128] \\
      [--scatter-impl {xla,xla_fastbwd,sorted,pallas,sorted_pallas}] \\
      [--use-pallas-fusion] [--use-pallas-kd] [--bf16] \\
      [--teacher-checkpoint teacher.pth [--teacher-checkpoint t1.pth ...] \\
       | --train-teacher [--num-teachers N]] \\
      [--cache-teacher [--cache-dtype {auto,bfloat16}] [--cache-hbm-gb 4]] \\
      [--lidar-encoder {spatial,pointpillars}] [--teacher-lidar-encoder ...] \\
      [--augment] [--aug-hflip P] [--aug-*] \\
      [--scan-steps K] [--onchip-epoch] [--onchip-eval] [--progress] \\
      [--snapshot-every N] [--handle-sigterm] [--async-checkpoint] \\
      [--save-dir checkpoints/distill_student] [--resume]

The best KD recipe (best_overall_results.json; scripts/experiment_best_overall.py):
  python -m lmsu_tpu_torch.train_distill --difficulty hard --fusion-type minimal \\
      --fusion-channels 128 --train-teacher --cache-teacher --cache-hbm-gb 6 \\
      --temperature 4 --augment --aug-hflip 0 --scan-steps 13 \\
      --scatter-impl pallas --use-pallas-kd
The cross-architecture recipe (kd_crossarch_best.json;
scripts/experiment_crossarch_best.py): a PointPillars student from a spatial
teacher, --lidar-encoder pointpillars --teacher-lidar-encoder spatial with
the flags above less the fusion ones.

The common flags are lmsu_tpu_torch/common.py's. The data is the synthetic
dataset. --scatter-impl takes the JAX package's five scatter-max
algorithms; with sorted_pallas the loaders sort each sample's points by BEV
cell (the sorted kernels' input contract), with the others the points stay
in their order. --use-pallas-fusion and --use-pallas-kd turn on the
fusion-gate (weighted fusion only) and feature-MSE kernels (the JAX
package's names). --cache-teacher computes the teacher's outputs once over
the training set (on clean inputs) and gathers them per step; the cache
spills to host memory above --cache-hbm-gb GiB. Augmentation (--augment,
--aug-*) covers both phases; with the cache it is noisy-student KD, and the
flip is refused. Checkpoints are torch files (latest.pth, best.pth) in
--save-dir beside training_history.json.
"""

from __future__ import annotations

import argparse
import dataclasses

from lmsu_tpu_torch.common import (add_common_args, apply_overrides, build_loaders,
                                   maybe_resume)
from lmsu_tpu_torch.config import (ExperimentConfig, KDConfig, ModelConfig, TrainConfig,
                                   teacher_config)

def build_configs(args):
    """(student ExperimentConfig, teacher ModelConfig). The teacher's width
    is anchored to the reference-size model, before any --width shrink."""
    ckpts = args.teacher_checkpoint or []
    kd = KDConfig(enabled=True, temperature=args.temperature, alpha_kl=args.alpha_kl,
                  beta_feature=args.beta_feature, teacher_width_mult=args.teacher_width,
                  teacher_checkpoint=ckpts[0] if len(ckpts) == 1 else None,
                  teacher_checkpoints=tuple(ckpts) if len(ckpts) > 1 else None,
                  ensemble_size=args.num_teachers if not ckpts else 1,
                  use_pallas=args.use_pallas_kd, cache_teacher=args.cache_teacher)
    if args.cache_hbm_gb is not None:
        kd = dataclasses.replace(kd, cache_hbm_limit_bytes=int(args.cache_hbm_gb * (1 << 30)))
    if args.cache_dtype is not None:
        kd = dataclasses.replace(kd, cache_dtype=args.cache_dtype)
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                          use_pallas_fusion=args.use_pallas_fusion),
        train=TrainConfig(num_epochs=20, class_weights=(0.4, 3.5),
                          save_dir="checkpoints/distill_student", kd=kd))
    cfg = apply_overrides(cfg, args)
    tcfg_model = teacher_config(cfg.model, args.teacher_width)
    if args.teacher_lidar_encoder is not None:
        tcfg_model = tcfg_model.replace(lidar=dataclasses.replace(
            tcfg_model.lidar, encoder_type=args.teacher_lidar_encoder))
    if args.width != 1.0:
        cfg = cfg.replace(model=teacher_config(cfg.model, args.width))
    return cfg, tcfg_model


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--use-pallas-fusion", action="store_true",
                   help="run the weighted-fusion gate through its kernel")
    p.add_argument("--use-pallas-kd", action="store_true",
                   help="run the feature-matching loss through its kernel")
    p.add_argument("--teacher-checkpoint", action="append", default=None,
                   help="trained teacher (.pth from this trainer, or a state dict); "
                   "else a random teacher; repeat it for an ensemble teacher "
                   "(member-averaged logits and taps)")
    p.add_argument("--train-teacher", action="store_true",
                   help="train the teacher first, then distill")
    p.add_argument("--num-teachers", type=int, default=1,
                   help="ensemble members: with --train-teacher, train this many "
                   "(init and data-order seeds offset by 1000 each) and distill "
                   "from their average; without it, random members")
    p.add_argument("--teacher-epochs", type=int, default=None)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha-kl", type=float, default=0.5)
    p.add_argument("--beta-feature", type=float, default=0.5)
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--width", type=float, default=1.0, help="student width multiplier")
    p.add_argument("--teacher-lidar-encoder", default=None, choices=["spatial", "pointpillars"],
                   help="the teacher's LiDAR encoder where it differs from the student's "
                   "(cross-architecture KD: both emit [B, C, H, W] BEV maps, so the "
                   "feature projections do not depend on the encoder)")
    p.add_argument("--cache-teacher", action="store_true",
                   help="compute the frozen teacher's outputs once over the training "
                   "set and gather them per step")
    p.add_argument("--cache-dtype", default=None, choices=["auto", "bfloat16"],
                   help="teacher-cache storage dtype (KDConfig.cache_dtype); bfloat16 "
                   "halves it")
    p.add_argument("--cache-hbm-gb", type=float, default=None,
                   help="device-memory budget of the teacher cache in GiB "
                   "(KDConfig.cache_hbm_limit_bytes, default 4); a larger cache "
                   "spills to host memory with a per-step gather and copy")
    return p


def main(argv=None) -> float:
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    from lmsu_tpu_torch.training import DistillationTrainer, Trainer
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    cfg, tcfg_model = build_configs(args)

    teacher_sd = None
    if args.train_teacher:
        members = []
        n = max(1, args.num_teachers)
        for i in range(n):
            tcfg = cfg.replace(model=tcfg_model, train=dataclasses.replace(
                cfg.train, kd=KDConfig(enabled=False),
                # Ensemble members differ in init and data order.
                seed=cfg.train.seed + 1000 * i,
                num_epochs=(args.teacher_epochs if args.teacher_epochs is not None
                            else cfg.train.num_epochs),
                save_dir=cfg.train.save_dir + ("_teacher" if i == 0 else f"_teacher{i}")))
            print(f"=== Phase 1: training teacher {i + 1}/{n} ===")
            tl, vl = build_loaders(tcfg)
            t_trainer = Trainer(tcfg, tl, vl, device=args.device)
            print(f"Teacher {i + 1} best mIoU: {t_trainer.train():.4f}")
            members.append(t_trainer.model.state_dict())
            del t_trainer
        teacher_sd = members if len(members) > 1 else members[0]

    print("=== Distilling student ===")
    train_loader, val_loader = build_loaders(cfg)
    trainer = DistillationTrainer(cfg, train_loader, val_loader, teacher_state_dict=teacher_sd,
                                  teacher_model_config=tcfg_model, device=args.device)
    best = trainer.train(maybe_resume(trainer, cfg, args.resume))
    print(f"Student best val mIoU: {best:.4f}")
    if trainer.last_loss_parts:
        print("Final loss parts:", trainer.last_loss_parts)
    return best


if __name__ == "__main__":
    main()
