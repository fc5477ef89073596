"""Cross-architecture KD: a spatial-encoder teacher into a PointPillars
student. The KD taps (camera_feat, lidar_feat, post_fusion) do not depend
on the LiDAR encoder, since both encoders emit a BEV map, so distillation
should transfer across encoders as it does across widths.

Counterpart of scripts/experiment_kd_crossarch.py, on kd_lift's regime
(hard synthetic, 400 / 512 samples, 40 epochs, arms paired per seed):
  1. teacher_spatial  the 2x-wide spatial-encoder model, labels alone;
  2. pp_student       the standard-width PointPillars model, labels alone;
  3. pp_student_kd    that student distilled from THIS seed's spatial
     teacher (its final weights as `teacher_state_dict=`, its model config
     as `teacher_model_config=`).

Usage:
  python -m lmsu_tpu_torch.experiments.kd_crossarch [--seeds 0 1 2] [--device cuda] \\
      [--teacher-width 2] [--teacher-epochs N] [--temperature 2] [--alpha-kl 0.5] \\
      [--beta-feature 0.5] [--output-root torch_runs] [--output FILE] [...]

Writes <output-root>/kd_crossarch_results.json (the script's schema), which
crossarch_best pairs with.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg, apply_overrides
from lmsu_tpu_torch.config import (DataConfig, ExperimentConfig, KDConfig, ModelConfig,
                                   TrainConfig, teacher_config)
from lmsu_tpu_torch.experiments import (add_kernel_args, run_dir, setup_device, train_arm,
                                        with_fusion_kernel, write_json)
from lmsu_tpu_torch.training import DistillationTrainer, Trainer


def _base_config(args) -> ExperimentConfig:
    """kd_lift's regime, so its spatial-student numbers compare directly."""
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        synthetic_num_train=400, synthetic_num_val=512, batch_size=32),
        train=TrainConfig(num_epochs=40, class_weights=(0.4, 3.5), onchip_epoch=True,
                          save_dir=run_dir(args, "kd_crossarch")))
    return with_fusion_kernel(apply_overrides(cfg, args), args)


def _pp_model(model: ModelConfig) -> ModelConfig:
    return model.replace(lidar=dataclasses.replace(model.lidar, encoder_type="pointpillars"))


def run_seed(seed: int, args) -> dict:
    base = _base_config(args)
    out = {}

    # -- 1. teacher: 2x-wide, SPATIAL lidar encoder ------------------------
    tmodel = teacher_config(base.model, args.teacher_width)
    tcfg = base.replace(model=tmodel, train=dataclasses.replace(
        base.train, seed=seed, num_epochs=args.teacher_epochs or base.train.num_epochs,
        save_dir=run_dir(args, f"kd_crossarch_teacher_s{seed}")))
    print(f"\n=== seed {seed}: spatial teacher (x{args.teacher_width}) ===", flush=True)
    out["teacher_spatial"], t_trainer = train_arm(tcfg, Trainer, args.device)
    teacher_sd = {k: v.detach().cpu() for k, v in t_trainer.model.state_dict().items()}
    del t_trainer

    # -- 2. PointPillars student alone -------------------------------------
    smodel = _pp_model(base.model)
    scfg = base.replace(model=smodel, train=dataclasses.replace(
        base.train, seed=seed, save_dir=run_dir(args, f"kd_crossarch_pp_student_s{seed}")))
    print(f"\n=== seed {seed}: PointPillars student alone ===", flush=True)
    out["pp_student"], _ = train_arm(scfg, Trainer, args.device)

    # -- 3. PointPillars student distilled from the spatial teacher --------
    kd = KDConfig(enabled=True, temperature=args.temperature, alpha_kl=args.alpha_kl,
                  beta_feature=args.beta_feature, teacher_width_mult=args.teacher_width,
                  use_pallas=args.use_pallas_kd)
    kcfg = base.replace(model=smodel, train=dataclasses.replace(
        base.train, seed=seed, kd=kd,
        save_dir=run_dir(args, f"kd_crossarch_pp_student_kd_s{seed}")))
    print(f"\n=== seed {seed}: PP student + KD from spatial teacher ===", flush=True)
    out["pp_student_kd"], _ = train_arm(kcfg, DistillationTrainer, args.device,
                                        teacher_state_dict=teacher_sd,
                                        teacher_model_config=tmodel)

    print(f"\nseed {seed}: teacher(spatial) {out['teacher_spatial']:.4f}  "
          f"pp_student {out['pp_student']:.4f}  pp_student+KD {out['pp_student_kd']:.4f}",
          flush=True)
    return out


def summarize(per_seed: dict, args) -> dict:
    arms = ("teacher_spatial", "pp_student", "pp_student_kd")
    mean = {a: sum(r[a] for r in per_seed.values()) / len(per_seed) for a in arms}
    spread = {a: max(r[a] for r in per_seed.values()) - min(r[a] for r in per_seed.values())
              for a in arms}
    gaps = {s: r["pp_student_kd"] - r["pp_student"] for s, r in per_seed.items()}
    base = _base_config(args)
    results = {
        "benchmark": "synthetic_hard",
        "experiment": "cross_architecture_kd",
        "teacher_lidar_encoder": "spatial",
        "student_lidar_encoder": "pointpillars",
        "config": {"num_train": base.data.synthetic_num_train,
                   "num_val": base.data.synthetic_num_val,
                   "epochs": base.train.num_epochs,
                   "batch_size": base.data.batch_size,
                   "teacher_width": args.teacher_width,
                   "temperature": args.temperature,
                   "alpha_kl": args.alpha_kl,
                   "beta_feature": args.beta_feature,
                   "seeds": sorted(int(s) for s in per_seed)},
        "per_seed": per_seed,
        "mean_miou": {a: round(mean[a], 4) for a in arms},
        "seed_spread": {a: round(spread[a], 4) for a in arms},
        "kd_gap_per_seed": {s: round(g, 4) for s, g in gaps.items()},
        "kd_gap_mean": round(sum(gaps.values()) / len(gaps), 4),
        "kd_gap_min": round(min(gaps.values()), 4),
        "kd_lift_every_seed": bool(min(gaps.values()) > 0),
    }

    print("\n=== Cross-architecture KD (spatial teacher -> PP student) ===")
    print(f"{'arm':>16s} {'mean mIoU':>10s} {'spread':>8s}   per-seed")
    for a in arms:
        vals = " ".join(f"{per_seed[s][a]:.4f}" for s in sorted(per_seed))
        print(f"{a:>16s} {mean[a]:10.4f} {spread[a]:8.4f}   {vals}")
    print("paired KD gap per seed: " + " ".join(f"{gaps[s]:+.4f}" for s in sorted(gaps)))
    print(f"KD gap: mean {results['kd_gap_mean']:+.4f}, min {results['kd_gap_min']:+.4f} "
          f"({'POSITIVE on every seed' if results['kd_lift_every_seed'] else 'NOT consistently positive'})")
    return results


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--teacher-epochs", type=int, default=None)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha-kl", type=float, default=0.5)
    p.add_argument("--beta-feature", type=float, default=0.5)
    p.add_argument("--output", default=None,
                   help="default <output-root>/kd_crossarch_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    per_seed = {str(seed): run_seed(seed, args) for seed in args.seeds}
    results = summarize(per_seed, args)
    output = args.output or os.path.join(args.output_root, "kd_crossarch_results.json")
    write_json(output, results)
    print(f"Wrote {output}")
    return results


if __name__ == "__main__":
    main()
