"""Ensemble-teacher KD: does a two-member deep-ensemble teacher beat the
single teacher under the best recipe? Per seed, through
`lmsu_tpu_torch.train_distill.main`.

Counterpart of scripts/experiment_kd_ensemble.py. It extends best_overall
(the minimal/128 student, noisy-student T=4 KD from an augment-trained 2x
minimal teacher) with a second teacher: the student distils from the
member-averaged logits and taps of two independently trained teachers
(init and data-order seeds offset by 1000; training/distill.py
EnsembleTeacher).

Pairing: member A is trained with best_overall's seed and configuration,
so its val-mIoU history should reproduce the paired best_overall run's
teacher; the single-teacher arm is that run's `student_best_recipe`, read
from the port's own <output-root>/best_overall_results.json, never the
TPU's. A teacher A that does not reproduce it is warned about, not fatal
(the pairing is then approximate). A rerun resumes as best_overall's does.

Usage:
  python -m lmsu_tpu_torch.experiments.kd_ensemble [--seeds 0 1 2] [--device cuda] \\
      [--output-root torch_runs] [--output FILE] \\
      [train_distill flags ...]

Further flags go to train_distill after REGIME's and override them. Writes
<output-root>/kd_ensemble_results.json (the script's schema).
"""

from __future__ import annotations

import json
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

#: best_overall's results file, under the output root.
BASELINE = "best_overall_results.json"


def _payload(per_seed):
    ens = [r["student_ensemble"] for r in per_seed.values()]
    single = [r["student_single_teacher_committed"] for r in per_seed.values()]
    return {"benchmark": "synthetic_hard",
            "config": {"regime": "kd_lift (400/512, 40ep)",
                       "student": "minimal/128 (494,978 params)",
                       "teacher": "2-member deep ensemble of 2x minimal, "
                                  "photometric-augment-trained, seeds "
                                  "offset 1000",
                       "recipe": "noisy-student KD, T=4, cached clean "
                                 "ensemble targets (mean logits/taps)",
                       "paired_against": "best_overall_results.json "
                                         "(member A bit-reproduces its "
                                         "teacher)",
                       "seeds": sorted(int(s) for s in per_seed)},
            "per_seed": per_seed,
            "mean_student_ensemble": round(sum(ens) / len(ens), 4),
            "mean_student_single": round(sum(single) / len(single), 4)}


def main(argv=None) -> dict:
    args, extra = recipe_parser(__doc__, "kd_ensemble_results.json").parse_known_args(argv)
    with open(os.path.join(args.output_root, BASELINE)) as f:
        baseline = json.load(f)["per_seed"]
    output = args.output or os.path.join(args.output_root, "kd_ensemble_results.json")
    per_seed = read_per_seed(output)

    for seed in args.seeds:
        save = run_dir(args, f"ensemble_best_s{seed}")
        seed_args = REGIME + ["--seed", str(seed), "--save-dir", save,
                              "--device", args.device] + extra
        ta = os.path.join(f"{save}_teacher", "best.pth")
        tb = os.path.join(f"{save}_teacher1", "best.pth")
        if os.path.exists(ta) and os.path.exists(tb):
            print(f"\n=== seed {seed}: reusing teachers ===", flush=True)
            seed_args += ["--teacher-checkpoint", ta, "--teacher-checkpoint", tb]
        else:
            print(f"\n=== seed {seed}: 2 teachers + ensemble distill ===", flush=True)
            seed_args += ["--train-teacher", "--num-teachers", "2"]
        best = float(train_distill.main(seed_args))

        t_a, t_b = teacher_best(f"{save}_teacher"), teacher_best(f"{save}_teacher1")
        paired = baseline[str(seed)]
        repro = abs(t_a - paired["teacher"]) < 1e-9
        if not repro:
            print(f"WARNING seed {seed}: teacher A {t_a!r} does not reproduce the baseline's "
                  f"{paired['teacher']!r}: the pairing with its single-teacher arm is "
                  "approximate")
        per_seed[str(seed)] = {
            "teacher_a": t_a, "teacher_b": t_b,
            "teacher_a_reproduces_committed": repro,
            "student_single_teacher_committed": paired["student_best_recipe"],
            "student_ensemble": best,
            "gap_vs_single": round(best - paired["student_best_recipe"], 6),
        }
        write_json(output, _payload(per_seed))
        print(f"seed {seed}: teachers {t_a:.4f}/{t_b:.4f} ensemble-student {best:.4f} "
              f"(single-teacher {paired['student_best_recipe']:.4f})")

    results = _payload(per_seed)
    print("\n=== ensemble-teacher KD (minimal/128 student, T=4 noisy) ===")
    for s, r in sorted(per_seed.items()):
        print(f"seed {s}: ensemble {r['student_ensemble']:.4f} vs single "
              f"{r['student_single_teacher_committed']:.4f} ({r['gap_vs_single']:+.4f})")
    print(f"mean ensemble student {results['mean_student_ensemble']:.4f} "
          f"vs single {results['mean_student_single']:.4f}")
    return results


if __name__ == "__main__":
    main()
