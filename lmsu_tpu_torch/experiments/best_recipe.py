"""Best-recipe composition: noisy-student KD at the sweep-best T=4.

Counterpart of scripts/experiment_best_recipe.py. It composes the two
strongest levers measured: noisy-student KD (augment_noisy: cached
clean-input teacher targets + a photometric / point-dropout student) and
T=4 distillation (kd_sweep). Same seeds and regime as the augment arms,
from the augment experiment's teacher of each seed; it appends the arm
`student_kd_noisy_t4` to augment's results so every gap stays paired.

With --width w != 1 the STUDENT shrinks (teacher_config scaling, as in
kd_compression) while the teacher stays the trained 2x model; the arm key
gains a `_w{w}` suffix.

Usage:
  python -m lmsu_tpu_torch.experiments.best_recipe [--seeds 0 1 2] [--device cuda] \\
      [--teacher-width 2] [--temperature 4] [--width 1] [--output-root torch_runs] \\
      [--output FILE] [--scatter-impl pallas] [--use-pallas-fusion] [--use-pallas-kd]

Run directories are <output-root>/checkpoints/best_recipe[_w<w>]_s<seed>/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg, build_loaders
from lmsu_tpu_torch.config import AugmentConfig, KDConfig, teacher_config
from lmsu_tpu_torch.experiments import add_kernel_args, run_dir, setup_device, write_json
from lmsu_tpu_torch.experiments.augment import _base_config
from lmsu_tpu_torch.experiments.augment_noisy import NOISY_AUGMENT, augment_teacher
from lmsu_tpu_torch.training import DistillationTrainer

ARM = "student_kd_noisy_t4"


def arm_key(args) -> str:
    return ARM if args.width == 1.0 else f"{ARM}_w{args.width:g}"


def run_seed(seed: int, args) -> float:
    base = _base_config(args)
    kd = KDConfig(enabled=True, teacher_width_mult=args.teacher_width,
                  temperature=args.temperature,
                  cache_teacher=True, teacher_checkpoint=augment_teacher(args, seed),
                  # 2x teacher f32 taps at 400 samples = 5.05 GB: keep the
                  # cache on the device.
                  cache_hbm_limit_bytes=6 << 30, use_pallas=args.use_pallas_kd)
    student_model = base.model if args.width == 1.0 else teacher_config(base.model, args.width)
    tag = "" if args.width == 1.0 else f"_w{args.width:g}"
    cfg = base.replace(
        model=student_model,
        train=dataclasses.replace(
            base.train, seed=seed, kd=kd, augment=AugmentConfig(**NOISY_AUGMENT),
            onchip_epoch=False, scan_steps=13,
            save_dir=run_dir(args, f"best_recipe{tag}_s{seed}")))
    print(f"\n=== seed {seed}: noisy-student KD, T={args.temperature}, "
          f"width {args.width:g} ===", flush=True)
    train_loader, val_loader = build_loaders(cfg)
    trainer = DistillationTrainer(
        cfg, train_loader, val_loader, device=args.device,
        teacher_model_config=teacher_config(base.model, args.teacher_width))
    return trainer.train()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--temperature", type=float, default=4.0)
    p.add_argument("--width", type=float, default=1.0,
                   help="student width multiplier (1.0 = reference size)")
    p.add_argument("--output", default=None, help="default <output-root>/augment_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    key = arm_key(args)
    output = args.output or os.path.join(args.output_root, "augment_results.json")
    with open(output) as f:
        results = json.load(f)

    for seed in args.seeds:
        best = run_seed(seed, args)
        results["per_seed"][str(seed)][key] = best
        write_json(output, results)
        print(f"seed {seed}: {key} {best:.4f}")

    rows = {s: r for s, r in results["per_seed"].items() if key in r}
    vs_teacher = {s: r[key] - r["teacher"] for s, r in rows.items()}
    results["config"]["best_recipe_temperature"] = args.temperature
    print(f"\n=== best recipe (noisy-student KD, T={args.temperature}, "
          f"width {args.width:g}) ===")
    if args.width == 1.0:
        vs_t2 = {s: r[key] - r["student_kd_noisy"] for s, r in rows.items()}
        results["best_recipe_vs_noisy_t2"] = {s: round(g, 4) for s, g in vs_t2.items()}
        results["best_recipe_vs_noisy_t2_mean"] = round(sum(vs_t2.values()) / len(vs_t2), 4)
        for s in sorted(rows):
            r = rows[s]
            print(f"seed {s}: teacher {r['teacher']:.4f}  noisy(T=2) "
                  f"{r['student_kd_noisy']:.4f}  noisy(T=4) {r[key]:.4f}  "
                  f"(vs T=2 {vs_t2[s]:+.4f}, vs teacher {vs_teacher[s]:+.4f})")
        print(f"vs noisy T=2: mean {results['best_recipe_vs_noisy_t2_mean']:+.4f}")
    else:
        for s in sorted(rows):
            print(f"seed {s}: teacher {rows[s]['teacher']:.4f}  {key} "
                  f"{rows[s][key]:.4f} (vs teacher {vs_teacher[s]:+.4f})")
    write_json(output, results)
    return results


if __name__ == "__main__":
    main()
