"""KD-lift experiment: student alone against student+KD against the teacher,
seeded, on the hard synthetic benchmark in a low-data regime (400 train /
512 val samples, 40 epochs, B=32), where the wide teacher generalises
better than the student and distillation has something to transfer.

Counterpart of scripts/experiment_kd_lift.py. Per seed:
  1. teacher     the 2x-wide model, labels alone;
  2. student     the standard weighted/128 model, labels alone;
  3. student_kd  the student distilled from THIS seed's teacher (CE + logit
     KL + feature matching, training/distill.py), whose final weights go
     to the DistillationTrainer as `teacher_state_dict=`.
The arms share the seed's data order and init streams, so the KD effect is
judged on the paired per-seed gap student_kd - student (`summarize`).

Usage:
  python -m lmsu_tpu_torch.experiments.kd_lift [--seeds 0 1 2] [--device cuda] \\
      [--teacher-width 2] [--teacher-epochs N] [--temperature 2] [--alpha-kl 0.5] \\
      [--beta-feature 0.5] [--output-root torch_runs] [--output FILE] \\
      [--scatter-impl sorted_pallas] [--use-pallas-fusion] [--use-pallas-kd]

Writes <output-root>/kd_comparison_results.json (the script's schema); run
directories <output-root>/checkpoints/kd_lift_<arm>_s<seed>/ hold each
arm's training_history.json and checkpoints (kd_sweep and kd_compression
read the teacher's latest.pth). The other flags are the common ones
(lmsu_tpu_torch/common.py).
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
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        # Low-data regime: the generalisation gap KD closes.
                        synthetic_num_train=400,
                        # A big val set: tight mIoU estimates (val samples are
                        # generated, they cost nothing).
                        synthetic_num_val=512,
                        batch_size=32),
        train=TrainConfig(num_epochs=40, class_weights=(0.4, 3.5), onchip_epoch=True,
                          save_dir=run_dir(args, "kd_lift")))
    return with_fusion_kernel(apply_overrides(cfg, args), args)


def run_seed(seed: int, args) -> dict:
    base = _base_config(args)
    out = {}

    # -- 1. teacher: 2x-wide, labels only ---------------------------------
    tmodel = teacher_config(base.model, args.teacher_width)
    tcfg = base.replace(model=tmodel, train=dataclasses.replace(
        base.train, seed=seed, num_epochs=args.teacher_epochs or base.train.num_epochs,
        save_dir=run_dir(args, f"kd_lift_teacher_s{seed}")))
    print(f"\n=== seed {seed}: teacher (width x{args.teacher_width}) ===", flush=True)
    out["teacher"], t_trainer = train_arm(tcfg, Trainer, args.device)
    teacher_sd = {k: v.detach().cpu() for k, v in t_trainer.model.state_dict().items()}
    del t_trainer

    # -- 2. student alone --------------------------------------------------
    scfg = base.replace(train=dataclasses.replace(
        base.train, seed=seed, save_dir=run_dir(args, f"kd_lift_student_s{seed}")))
    print(f"\n=== seed {seed}: student alone ===", flush=True)
    out["student"], _ = train_arm(scfg, Trainer, args.device)

    # -- 3. student + KD from this seed's teacher --------------------------
    kd = KDConfig(enabled=True, temperature=args.temperature, alpha_kl=args.alpha_kl,
                  beta_feature=args.beta_feature, teacher_width_mult=args.teacher_width,
                  use_pallas=args.use_pallas_kd)
    kcfg = base.replace(train=dataclasses.replace(
        base.train, seed=seed, kd=kd, save_dir=run_dir(args, f"kd_lift_student_kd_s{seed}")))
    print(f"\n=== seed {seed}: student + KD ===", flush=True)
    out["student_kd"], _ = train_arm(kcfg, DistillationTrainer, args.device,
                                     teacher_state_dict=teacher_sd)

    print(f"\nseed {seed}: teacher {out['teacher']:.4f}  student {out['student']:.4f}  "
          f"student+KD {out['student_kd']:.4f}", flush=True)
    return out


def summarize(per_seed: dict, args) -> dict:
    """Aggregate per-seed arm results into the published comparison.

    The three arms share each seed (data order, init streams), so the KD
    effect is judged on the paired per-seed gap student_kd - student: the
    unpaired cross-seed spread mixes seed difficulty into the arm variance
    (a hard seed moves all arms together)."""
    arms = ("teacher", "student", "student_kd")
    mean = {a: sum(r[a] for r in per_seed.values()) / len(per_seed) for a in arms}
    spread = {a: max(r[a] for r in per_seed.values()) - min(r[a] for r in per_seed.values())
              for a in arms}
    gaps = {s: r["student_kd"] - r["student"] for s, r in per_seed.items()}
    base = _base_config(args)
    results = {
        "benchmark": "synthetic_hard",
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

    print("\n=== KD lift (hard synthetic benchmark) ===")
    print(f"{'arm':>12s} {'mean mIoU':>10s} {'spread':>8s}   per-seed")
    for a in arms:
        vals = " ".join(f"{per_seed[s][a]:.4f}" for s in sorted(per_seed))
        print(f"{a:>12s} {mean[a]:10.4f} {spread[a]:8.4f}   {vals}")
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
                   help="default <output-root>/kd_comparison_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    per_seed = {str(seed): run_seed(seed, args) for seed in args.seeds}
    results = summarize(per_seed, args)
    output = args.output or os.path.join(args.output_root, "kd_comparison_results.json")
    write_json(output, results)
    print(f"Wrote {output}")
    return results


if __name__ == "__main__":
    main()
