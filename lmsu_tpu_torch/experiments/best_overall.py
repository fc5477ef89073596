"""Best-overall-model run: the best recipe applied to the best family, per
seed, through `lmsu_tpu_torch.train_distill.main` (the public CLI).

Counterpart of scripts/experiment_best_overall.py. The minimal/128 student
(494,978 parameters) under the full best recipe:
  1. a 2x-wide minimal teacher trained WITH the photometric augmentation
     (the augment flag covers both phases of train_distill);
  2. noisy-student distillation at T=4: the teacher's targets cached once
     from CLEAN inputs, the augmentation (no flip) on the student only, the
     cache on the device under 6 GiB (the 2x minimal teacher's f32 taps of
     400 samples take 5.05 GB).
A rerun resumes: seeds already in the output are kept, and a teacher whose
best.pth exists is reused (distillation only).

Usage:
  python -m lmsu_tpu_torch.experiments.best_overall [--seeds 0 1 2] [--device cuda] \\
      [--output-root torch_runs] [--output FILE] [train_distill flags ...]

Further flags go to train_distill after REGIME's and override them (e.g.
--scatter-impl pallas --use-pallas-kd for the kernels, --epochs 1 for a
short run). Writes <output-root>/best_overall_results.json (the script's
schema), which kd_ensemble pairs with; run directories are
<output-root>/checkpoints/best_overall_minimal_s<seed>[_teacher]/.
"""

from __future__ import annotations

import os

from lmsu_tpu_torch import train_distill
from lmsu_tpu_torch.experiments import read_per_seed, recipe_parser, run_dir, teacher_best, \
    write_json

REGIME = ["--dataset", "synthetic", "--difficulty", "hard",
          "--num-train", "400", "--num-val", "512", "--epochs", "40",
          "--batch-size", "32", "--fusion-type", "minimal",
          "--fusion-channels", "128", "--cache-teacher",
          "--cache-hbm-gb", "6", "--temperature", "4",
          "--augment", "--aug-hflip", "0", "--scan-steps", "13"]


def _payload(per_seed):
    vals = [r["student_best_recipe"] for r in per_seed.values()]
    return {"benchmark": "synthetic_hard",
            "config": {"regime": "kd_lift (400/512, 40ep)",
                       "student": "minimal/128 (494,978 params)",
                       "teacher": "2x minimal, photometric-augment-trained",
                       "recipe": "noisy-student KD, T=4, cached clean "
                                 "teacher targets",
                       "seeds": sorted(int(s) for s in per_seed)},
            "per_seed": per_seed,
            "mean_student": round(sum(vals) / len(vals), 4)}


def main(argv=None) -> dict:
    args, extra = recipe_parser(__doc__, "best_overall_results.json").parse_known_args(argv)
    output = args.output or os.path.join(args.output_root, "best_overall_results.json")
    per_seed = read_per_seed(output)

    for seed in args.seeds:
        save = run_dir(args, f"best_overall_minimal_s{seed}")
        tck = os.path.join(f"{save}_teacher", "best.pth")
        seed_args = REGIME + ["--seed", str(seed), "--save-dir", save,
                              "--device", args.device] + extra
        if os.path.exists(tck):
            # Teacher already trained (a rerun): distill only.
            print(f"\n=== seed {seed}: reusing teacher {tck} ===", flush=True)
            seed_args += ["--teacher-checkpoint", tck]
        else:
            print(f"\n=== seed {seed}: teacher + distill ===", flush=True)
            seed_args += ["--train-teacher"]
        best = float(train_distill.main(seed_args))
        t_best = teacher_best(f"{save}_teacher")
        per_seed[str(seed)] = {"teacher": t_best, "student_best_recipe": best}
        write_json(output, _payload(per_seed))
        print(f"seed {seed}: teacher {t_best:.4f} student {best:.4f}")

    results = _payload(per_seed)
    print("\n=== best overall model (minimal/128 student, best recipe) ===")
    for s, r in sorted(per_seed.items()):
        print(f"seed {s}: teacher {r['teacher']:.4f}  student {r['student_best_recipe']:.4f}")
    print(f"mean student {results['mean_student']:.4f}")
    return results


if __name__ == "__main__":
    main()
