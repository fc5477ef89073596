"""KD hyperparameter sweep: temperature and loss-weight sensitivity around
kd_lift's defaults (T=2, alpha_kl=0.5, beta_feature=0.5), one seed.

Counterpart of scripts/experiment_kd_sweep.py. Every arm shares the seed's
data order and init and the SAME trained teacher (the seed's kd_lift
teacher, <output-root>/checkpoints/kd_lift_teacher_s<seed>/latest.pth,
written by `python -m lmsu_tpu_torch.experiments.kd_lift`), so differences
come from the KD loss configuration alone. The teacher is cached once over
the training set (KDConfig.cache_teacher), so no arm pays a teacher forward
a step. The baselines come from the port's kd_lift results
(<output-root>/kd_comparison_results.json), never from the TPU's.

Usage:
  python -m lmsu_tpu_torch.experiments.kd_sweep [--seed 0] [--device cuda] \\
      [--configs NAME ...] [--teacher-checkpoint <teacher>.pth] \\
      [--output-root torch_runs] [--output FILE] [--use-pallas-kd] [...]

Writes <output-root>/kd_sweep_results.json (the script's schema).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg
from lmsu_tpu_torch.config import KDConfig
from lmsu_tpu_torch.experiments import (add_kernel_args, run_dir, setup_device, train_arm,
                                        write_json)
from lmsu_tpu_torch.experiments.kd_lift import _base_config
from lmsu_tpu_torch.training import DistillationTrainer

# (name, temperature, alpha_kl, beta_feature)
GRID = (
    ("T1_a.5_b.5", 1.0, 0.5, 0.5),
    ("T4_a.5_b.5", 4.0, 0.5, 0.5),
    ("T2_a.25_b.5", 2.0, 0.25, 0.5),
    ("T2_a.75_b.5", 2.0, 0.75, 0.5),
    ("T2_a.5_b0_logit_only", 2.0, 0.5, 0.0),
    ("T2_a0_b.5_feature_only", 2.0, 0.0, 0.5),
)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--teacher-checkpoint", default=None,
                   help="default <output-root>/checkpoints/kd_lift_teacher_s<seed>/latest.pth")
    p.add_argument("--output", default=None, help="default <output-root>/kd_sweep_results.json")
    p.add_argument("--configs", nargs="+", default=None, choices=[g[0] for g in GRID],
                   help="run only these GRID entries (e.g. to replicate one config on "
                   "another seed)")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    seed = args.seed if args.seed is not None else 0
    tck = args.teacher_checkpoint or os.path.join(run_dir(args, f"kd_lift_teacher_s{seed}"),
                                                  "latest.pth")
    with open(os.path.join(args.output_root, "kd_comparison_results.json")) as f:
        ref = json.load(f)["per_seed"][str(seed)]

    grid = [g for g in GRID if args.configs is None or g[0] in args.configs]
    results = {}
    for name, temp, a_kl, b_feat in grid:
        kd = KDConfig(enabled=True, temperature=temp, alpha_kl=a_kl, beta_feature=b_feat,
                      teacher_width_mult=2.0, teacher_checkpoint=tck, cache_teacher=True,
                      use_pallas=args.use_pallas_kd)
        base = _base_config(args)
        cfg = base.replace(train=dataclasses.replace(
            base.train, seed=seed, kd=kd, save_dir=run_dir(args, f"kd_sweep_{name}_s{seed}")))
        print(f"\n=== {name} (T={temp}, alpha_kl={a_kl}, beta_feature={b_feat}) ===",
              flush=True)
        results[name] = float(train_arm(cfg, DistillationTrainer, args.device)[0])

    out = {"seed": seed, "benchmark": "synthetic_hard",
           "baselines": {"student_alone": ref["student"],
                         "student_kd_T2_a.5_b.5": ref["student_kd"],
                         "teacher": ref["teacher"]},
           "sweep": results}
    write_json(args.output or os.path.join(args.output_root, "kd_sweep_results.json"), out)
    print(f"\n=== KD sweep (seed {seed}, hard benchmark) ===")
    for k, v in sorted(out["sweep"].items(), key=lambda kv: -kv[1]):
        print(f"{k:>26s}  {v:.4f}")
    print(f"{'(default) T2_a.5_b.5':>26s}  {ref['student_kd']:.4f}")
    print(f"{'student alone':>26s}  {ref['student']:.4f}")
    return out


if __name__ == "__main__":
    main()
