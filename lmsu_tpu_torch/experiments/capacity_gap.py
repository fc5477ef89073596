"""Teacher-student capacity gap: does a bigger teacher hurt a SMALL student?

Counterpart of scripts/experiment_capacity_gap.py. The half-width minimal
student (teacher_config scaling) distilled with the best recipe from
teachers of width 1 / 2 / 4 (same seed, regime and program, so the cells
are paired with each other and with teacher_scaling's full-size rows):
per teacher width, train the augment-trained minimal teacher, then distil
into the student through `lmsu_tpu_torch.train_distill.main` (--width 0.5
--teacher-width W). A width already in the output is skipped; a teacher
whose best.pth exists is reused.

Each fresh teacher is set beside the port's own earlier teacher run of the
same width and seed, where there is one under the output root
(teacher_scaling's tscale_w<w>_s<seed>_teacher, best_overall's
best_overall_minimal_s<seed>_teacher): the row records whether it
reproduces that run's best val mIoU. Where there is none the row has no
such entry.

Usage:
  python -m lmsu_tpu_torch.experiments.capacity_gap [--teacher-widths 1 2 4] \\
      [--student-width 0.5] [--seed 0] [--device cuda] [--output-root torch_runs] \\
      [--output FILE] [train_distill flags ...]

Writes <output-root>/capacity_gap_results.json; run directories are
<output-root>/checkpoints/capgap_tw<w>_s<seed>[_teacher]/.
"""

from __future__ import annotations

import json
import os

from lmsu_tpu_torch import train_distill
from lmsu_tpu_torch.experiments import (recipe_parser, run_dir, setup_device, teacher_best,
                                        write_json)
from lmsu_tpu_torch.experiments.teacher_scaling import REGIME, _cache_gb


def earlier_teachers(args):
    """The port's own earlier teacher runs of `args.seed` by width: the run
    directory whose training_history.json a fresh teacher should reproduce
    (teacher_scaling's widths, best_overall's 2x minimal teacher)."""
    s = args.seed
    return {1.0: run_dir(args, f"tscale_w1.0_s{s}_teacher"),
            2.0: run_dir(args, f"best_overall_minimal_s{s}_teacher"),
            4.0: run_dir(args, f"tscale_w4.0_s{s}_teacher")}


def main(argv=None) -> dict:
    p = recipe_parser(__doc__, "capacity_gap_results.json", seeds=False)
    p.add_argument("--teacher-widths", type=float, nargs="+", default=[1.0, 2.0, 4.0])
    p.add_argument("--student-width", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    args, extra = p.parse_known_args(argv)
    setup_device(args)
    output = args.output or os.path.join(args.output_root, "capacity_gap_results.json")
    try:
        with open(output) as f:
            per_tw = json.load(f)["per_teacher_width"]
    except FileNotFoundError:
        per_tw = {}

    for tw in args.teacher_widths:
        if str(tw) in per_tw:
            print(f"teacher width {tw}: already measured, skipping")
            continue
        save = run_dir(args, f"capgap_tw{tw}_s{args.seed}")
        run_args = REGIME + ["--seed", str(args.seed), "--save-dir", save,
                             "--width", str(args.student_width), "--teacher-width", str(tw),
                             "--cache-hbm-gb", _cache_gb(tw)]
        if tw >= 3.0:
            # The f32 cache at w=4 is ~10.1 GB; bf16 halves it, as in
            # teacher_scaling.
            run_args += ["--cache-dtype", "bfloat16"]
        tck = os.path.join(f"{save}_teacher", "best.pth")
        if os.path.exists(tck):
            print(f"\n=== teacher w={tw}: distill from existing ckpt ===", flush=True)
            run_args += ["--teacher-checkpoint", tck]
        else:
            print(f"\n=== teacher w={tw}: teacher + distill ===", flush=True)
            run_args += ["--train-teacher"]
        best = float(train_distill.main(run_args + ["--device", args.device] + extra))
        t_best = teacher_best(f"{save}_teacher")
        row = {"teacher": t_best, "student": best}
        earlier = earlier_teachers(args).get(tw)
        if earlier and os.path.exists(os.path.join(earlier, "training_history.json")):
            earlier_best = teacher_best(earlier)
            row["teacher_reproduces_committed"] = abs(earlier_best - t_best) < 1e-12
            row["committed_teacher"] = earlier_best
        if tw >= 3.0:
            row["cache_dtype"] = "bfloat16"
        per_tw[str(tw)] = row
        write_json(output, _payload(per_tw, args))
        print(f"teacher w={tw}: teacher {t_best:.4f} "
              f"student(w={args.student_width:g}) {best:.4f}")

    print(f"\n=== capacity gap (minimal family, student w={args.student_width:g}, "
          f"best recipe, seed {args.seed}) ===")
    for tw, r in sorted(per_tw.items(), key=lambda t: float(t[0])):
        print(f"teacher w={tw}: teacher {r['teacher']:.4f} student {r['student']:.4f}")
    return _payload(per_tw, args)


def _payload(per_tw, args):
    return {"benchmark": "synthetic_hard",
            "config": {"regime": "kd_lift (400/512, 40ep)",
                       "student": f"minimal, width {args.student_width:g} "
                                  "(teacher_config scaling)",
                       "teacher": "minimal, width-multiplied, photometric-augment-trained",
                       "recipe": "noisy-student KD, T=4, cached clean teacher targets",
                       "seed": args.seed},
            "full_size_student_rows": "teacher_scaling_results.json",
            "per_teacher_width": per_tw}


if __name__ == "__main__":
    main()
