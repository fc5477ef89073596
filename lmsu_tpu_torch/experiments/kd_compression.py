"""KD compression sweep: how small can the student go? Each width in
--widths scales the whole student (teacher_config with width_mult < 1) and
is trained alone and distilled from the SAME 2x teacher (cached), seed-paired
with kd_lift's runs; learned per-tap projections absorb the channel
mismatch.

Counterpart of scripts/experiment_kd_compression.py. The teacher is the
seed's kd_lift teacher (<output-root>/checkpoints/kd_lift_teacher_s<seed>/
latest.pth) and the width-1 reference points come from the port's kd_lift
results (<output-root>/kd_comparison_results.json), never from the TPU's.
Parameter counts are the port's count_parameters of each model.

Usage:
  python -m lmsu_tpu_torch.experiments.kd_compression [--seed 0] [--device cuda] \\
      [--widths 0.5 0.25] [--teacher-checkpoint <teacher>.pth] \\
      [--output-root torch_runs] [--output FILE] [...]

Writes <output-root>/kd_compression_results.json (the script's schema).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg
from lmsu_tpu_torch.config import KDConfig, teacher_config
from lmsu_tpu_torch.experiments import (add_kernel_args, run_dir, setup_device, train_arm,
                                        write_json)
from lmsu_tpu_torch.experiments.kd_lift import _base_config
from lmsu_tpu_torch.models import count_parameters, create_model
from lmsu_tpu_torch.training import DistillationTrainer, Trainer


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--widths", type=float, nargs="+", default=[0.5, 0.25])
    p.add_argument("--teacher-checkpoint", default=None,
                   help="default <output-root>/checkpoints/kd_lift_teacher_s<seed>/latest.pth")
    p.add_argument("--output", default=None,
                   help="default <output-root>/kd_compression_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    seed = args.seed if args.seed is not None else 0
    tck = args.teacher_checkpoint or os.path.join(run_dir(args, f"kd_lift_teacher_s{seed}"),
                                                  "latest.pth")
    with open(os.path.join(args.output_root, "kd_comparison_results.json")) as f:
        ref = json.load(f)["per_seed"][str(seed)]

    base = _base_config(args)
    teacher_cfg = teacher_config(base.model, 2.0)  # the trained 2x teacher

    results = {}
    for w in args.widths:
        tag = f"w{w:g}"
        student_model = teacher_config(base.model, w) if w != 1.0 else base.model
        n_params = count_parameters(create_model(student_model))
        row = {"params": n_params}

        scfg = base.replace(model=student_model, train=dataclasses.replace(
            base.train, seed=seed, save_dir=run_dir(args, f"kd_compress_{tag}_s{seed}")))
        print(f"\n=== width {w}: student alone ({n_params:,} params) ===", flush=True)
        row["student"] = float(train_arm(scfg, Trainer, args.device)[0])

        kd = KDConfig(enabled=True, temperature=2.0, alpha_kl=0.5, beta_feature=0.5,
                      teacher_checkpoint=tck, cache_teacher=True, use_pallas=args.use_pallas_kd)
        kcfg = base.replace(model=student_model, train=dataclasses.replace(
            base.train, seed=seed, kd=kd, save_dir=run_dir(args, f"kd_compress_{tag}_kd_s{seed}")))
        print(f"\n=== width {w}: student + KD ===", flush=True)
        row["student_kd"] = float(train_arm(kcfg, DistillationTrainer, args.device,
                                            teacher_model_config=teacher_cfg)[0])
        row["kd_gap"] = round(row["student_kd"] - row["student"], 4)
        results[tag] = row

    w1_params = count_parameters(create_model(base.model))
    out = {"benchmark": "synthetic_hard", "seed": seed,
           "teacher": {"params": count_parameters(create_model(teacher_cfg)),
                       "miou": ref["teacher"]},
           "w1_reference": {"params": w1_params, "student": ref["student"],
                            "student_kd": ref["student_kd"]},
           "sweep": results}
    write_json(args.output or os.path.join(args.output_root, "kd_compression_results.json"), out)
    print(f"\n=== KD compression (seed {seed}) ===")
    print(f"{'width':>6s} {'params':>10s} {'student':>8s} {'+KD':>8s} {'gap':>7s}")
    print(f"{'1.0':>6s} {w1_params:>10,d} {ref['student']:8.4f} "
          f"{ref['student_kd']:8.4f} {ref['student_kd'] - ref['student']:+7.4f}")
    for tag, r in results.items():
        print(f"{tag[1:]:>6s} {r['params']:>10,d} {r['student']:8.4f} "
              f"{r['student_kd']:8.4f} {r['kd_gap']:+7.4f}")
    return out


if __name__ == "__main__":
    main()
