"""Best recipe x cross-architecture KD: does the best recipe (noisy-student
KD, T=4, cached clean-input teacher targets) lift a student whose LiDAR
encoder differs from the teacher's? Per seed, through
`lmsu_tpu_torch.train_distill.main`.

Counterpart of scripts/experiment_crossarch_best.py:
  teacher  the 2x-wide SPATIAL-encoder weighted model, trained WITH the
           photometric augmentation (as in best_overall);
  student  the standard-width POINTPILLARS weighted model, distilled
           noisy-student style at temperature 4.
The paired baselines are kd_crossarch's arms (same seeds, regime and
student): `pp_student` (plain) and `pp_student_kd` (in-loop T=2), read
from --baseline, by default the port's own
<output-root>/kd_crossarch_results.json, never the TPU's. A rerun resumes
as best_overall's does.

Usage:
  python -m lmsu_tpu_torch.experiments.crossarch_best [--seeds 0 1 2] \\
      [--device cuda] [--baseline FILE] [--output-root torch_runs] [--output FILE] \\
      [train_distill flags ...]

Further flags go to train_distill after REGIME's and override them. Writes
<output-root>/kd_crossarch_best.json (the script's schema).
"""

from __future__ import annotations

import json
import os

from lmsu_tpu_torch import train_distill
from lmsu_tpu_torch.experiments import read_per_seed, recipe_parser, run_dir, teacher_best, \
    write_json

REGIME = ["--dataset", "synthetic", "--difficulty", "hard",
          "--num-train", "400", "--num-val", "512", "--epochs", "40",
          "--batch-size", "32",
          "--lidar-encoder", "pointpillars",
          "--teacher-lidar-encoder", "spatial",
          "--cache-teacher", "--cache-hbm-gb", "6", "--temperature", "4",
          "--augment", "--aug-hflip", "0", "--scan-steps", "13"]


def _payload(per_seed, args):
    out = {"benchmark": "synthetic_hard",
           "experiment": "best_recipe_cross_architecture",
           "config": {"regime": "kd_lift (400/512, 40ep)",
                      "student": "weighted/128 PointPillars",
                      "teacher": "2x weighted spatial, "
                                 "photometric-augment-trained",
                      "recipe": "noisy-student KD, T=4, cached clean "
                                "teacher targets",
                      "paired_baselines": args.baseline,
                      "seeds": sorted(int(s) for s in per_seed)},
           "per_seed": dict(per_seed)}
    # Paired gaps against the cross-arch arms (same seeds and regime).
    try:
        with open(args.baseline) as f:
            base = json.load(f)["per_seed"]
    except FileNotFoundError:
        base = {}
    gaps = []
    for s, r in out["per_seed"].items():
        if s in base:
            r["vs_plain"] = round(r["pp_student_best_recipe"] - base[s]["pp_student"], 4)
            r["vs_kd_t2"] = round(r["pp_student_best_recipe"] - base[s]["pp_student_kd"], 4)
            gaps.append(r["vs_plain"])
    if gaps:
        out["recipe_gap_mean"] = round(sum(gaps) / len(gaps), 4)
        out["recipe_gap_min"] = round(min(gaps), 4)
        out["recipe_lift_every_seed"] = bool(min(gaps) > 0)
    vals = [r["pp_student_best_recipe"] for r in per_seed.values()]
    out["mean_student"] = round(sum(vals) / len(vals), 4)
    return out


def main(argv=None) -> dict:
    p = recipe_parser(__doc__, "kd_crossarch_best.json")
    p.add_argument("--baseline", default=None,
                   help="kd_crossarch's results; default <output-root>/kd_crossarch_results.json")
    args, extra = p.parse_known_args(argv)
    args.baseline = args.baseline or os.path.join(args.output_root, "kd_crossarch_results.json")
    output = args.output or os.path.join(args.output_root, "kd_crossarch_best.json")
    per_seed = read_per_seed(output)

    for seed in args.seeds:
        save = run_dir(args, f"crossarch_best_s{seed}")
        tck = os.path.join(f"{save}_teacher", "best.pth")
        seed_args = REGIME + ["--seed", str(seed), "--save-dir", save,
                              "--device", args.device] + extra
        if os.path.exists(tck):
            print(f"\n=== seed {seed}: reusing teacher {tck} ===", flush=True)
            seed_args += ["--teacher-checkpoint", tck]
        else:
            print(f"\n=== seed {seed}: teacher + distill ===", flush=True)
            seed_args += ["--train-teacher"]
        best = float(train_distill.main(seed_args))
        per_seed[str(seed)] = {"teacher_spatial_aug": teacher_best(f"{save}_teacher"),
                               "pp_student_best_recipe": best}
        write_json(output, _payload(per_seed, args))
        print(f"seed {seed}: teacher {per_seed[str(seed)]['teacher_spatial_aug']:.4f} "
              f"student {best:.4f}")

    results = _payload(per_seed, args)
    print("\n=== best recipe x cross-arch (spatial teacher -> PP student) ===")
    for s, r in sorted(results["per_seed"].items()):
        line = (f"seed {s}: teacher {r['teacher_spatial_aug']:.4f}  "
                f"recipe {r['pp_student_best_recipe']:.4f}")
        if "vs_plain" in r:
            line += (f"  (vs plain {r['vs_plain']:+.4f}, "
                     f"vs in-loop T=2 KD {r['vs_kd_t2']:+.4f})")
        print(line)
    if "recipe_gap_mean" in results:
        print(f"paired gap vs plain student: mean {results['recipe_gap_mean']:+.4f}, "
              f"min {results['recipe_gap_min']:+.4f}")
    return results


if __name__ == "__main__":
    main()
