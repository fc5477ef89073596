"""Noisy-student KD arm: a cached clean-input teacher and a photometric
student (Xie et al. 2020 style).

Counterpart of scripts/experiment_augment_noisy.py, the follow-up to the
augment experiment: KDConfig.cache_teacher with a geometry-free
augmentation (photometric + point dropout), so the teacher's cached
targets come from CLEAN inputs while the student sees augmented ones (the
composition ops/augment.py's rules recommend). It distils from the augment
experiment's teacher of the same seed
(<output-root>/checkpoints/augment_teacher_s<seed>/best.pth) and appends
the arm `student_kd_noisy` to augment's results (--output, default
<output-root>/augment_results.json).

Usage:
  python -m lmsu_tpu_torch.experiments.augment_noisy [--seeds 0 1 2] \\
      [--device cuda] [--teacher-width 2] [--output-root torch_runs] [--output FILE] \\
      [--scatter-impl pallas] [--use-pallas-fusion] [--use-pallas-kd]

The point dropout moves points, so --scatter-impl sorted_pallas is refused
(ops/augment.py::check_augment_compat).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg, build_loaders
from lmsu_tpu_torch.config import AugmentConfig, KDConfig
from lmsu_tpu_torch.experiments import add_kernel_args, run_dir, setup_device, write_json
from lmsu_tpu_torch.experiments.augment import _base_config
from lmsu_tpu_torch.training import DistillationTrainer

# Geometry-free recipe: everything from STANDARD_AUGMENT except hflip
# (spatial terms are incompatible with the cached teacher's spatial taps).
NOISY_AUGMENT = dict(enabled=True, brightness=0.1, contrast=0.1,
                     image_noise_std=0.02, point_dropout=0.05)


def augment_teacher(args, seed: int) -> str:
    """The augment experiment's teacher checkpoint of `seed`; raises naming
    the run that makes it when it is missing."""
    path = os.path.join(run_dir(args, f"augment_teacher_s{seed}"), "best.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — run python -m lmsu_tpu_torch.experiments.augment "
            f"--seeds {seed} first (it trains and saves the seed's teacher)")
    return path


def run_seed(seed: int, args) -> float:
    base = _base_config(args)
    kd = KDConfig(enabled=True, teacher_width_mult=args.teacher_width,
                  cache_teacher=True, teacher_checkpoint=augment_teacher(args, seed),
                  # The 2x teacher's f32 taps for 400 samples take 5.05 GB,
                  # over the 4 GB default; on the device they save a host
                  # gather every step.
                  cache_hbm_limit_bytes=6 << 30, use_pallas=args.use_pallas_kd)
    cfg = base.replace(train=dataclasses.replace(
        base.train, seed=seed, kd=kd, augment=AugmentConfig(**NOISY_AUGMENT),
        # cache gathers ride the host loop; onchip_epoch is in-loop-only
        onchip_epoch=False, scan_steps=13,
        save_dir=run_dir(args, f"augment_student_kd_noisy_s{seed}")))
    print(f"\n=== seed {seed}: noisy-student KD (cached clean teacher + "
          f"photometric augment) ===", flush=True)
    train_loader, val_loader = build_loaders(cfg)
    trainer = DistillationTrainer(cfg, train_loader, val_loader, device=args.device)
    return trainer.train()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--output", default=None, help="default <output-root>/augment_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    output = args.output or os.path.join(args.output_root, "augment_results.json")
    with open(output) as f:
        results = json.load(f)

    for seed in args.seeds:
        best = run_seed(seed, args)
        results["per_seed"][str(seed)]["student_kd_noisy"] = best
        write_json(output, results)
        print(f"seed {seed}: noisy-student KD {best:.4f}")

    rows = {s: r for s, r in results["per_seed"].items() if "student_kd_noisy" in r}
    gaps = {s: r["student_kd_noisy"] - r["student"] for s, r in rows.items()}
    vs_aug = {s: r["student_kd_noisy"] - r["student_aug"] for s, r in rows.items()}
    results["config"]["noisy_augment"] = dict(NOISY_AUGMENT)
    results["noisy_gap_per_seed"] = {s: round(g, 4) for s, g in gaps.items()}
    results["noisy_gap_mean"] = round(sum(gaps.values()) / len(gaps), 4)
    results["noisy_vs_aug_mean"] = round(sum(vs_aug.values()) / len(vs_aug), 4)
    write_json(output, results)

    print("\n=== noisy-student KD (cached clean teacher) ===")
    for s in sorted(rows):
        r = rows[s]
        print(f"seed {s}: student {r['student']:.4f}  +aug "
              f"{r['student_aug']:.4f}  kd+aug(in-loop) "
              f"{r['student_kd_aug']:.4f}  noisy-student "
              f"{r['student_kd_noisy']:.4f}")
    print(f"vs plain student: mean {results['noisy_gap_mean']:+.4f}; "
          f"vs aug-alone: mean {results['noisy_vs_aug_mean']:+.4f}")
    return results


if __name__ == "__main__":
    main()
