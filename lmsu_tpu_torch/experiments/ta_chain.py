"""Teacher-assistant chain: w=4 -> w=1 (TA) -> w=0.5 progressive KD.

Counterpart of scripts/experiment_ta_chain.py, the companion of
capacity_gap: if the half-width student learns less from the 4x teacher
than from a closer one, the classic fix (Mirzadeh et al.) is a two-hop
chain through an intermediate "teacher assistant". It reuses capacity_gap's
trained w=4 teacher:

  stage A: distil the w=4 teacher into a full-size (w=1) TA with the best
           recipe, the configuration of teacher_scaling's w=4 row (so it
           doubles as a reproduction of that number);
  stage B: distil the TA into the w=0.5 student (teacher width 1, the TA's
           best.pth as the teacher checkpoint: a KD student's checkpoint
           loads as a teacher).

Comparable cells: capacity_gap's direct w4 / w2 / w1 -> 0.5 of the port's
own run (<output-root>/capacity_gap_results.json). The payload's
`tscale_w4_student_committed` is the port's own teacher_scaling w=4
student (<output-root>/teacher_scaling_results.json), or null where that
run is missing. Both stages go through `lmsu_tpu_torch.train_distill.main`.

Usage:
  python -m lmsu_tpu_torch.experiments.ta_chain [--seed 0] [--w4-teacher PATH] \\
      [--device cuda] [--output-root torch_runs] [--output FILE] [train_distill flags ...]

Writes <output-root>/ta_chain_results.json; run directories are
<output-root>/checkpoints/ta_chain_{ta,student}_s<seed>/.
"""

from __future__ import annotations

import json
import os

from lmsu_tpu_torch import train_distill
from lmsu_tpu_torch.experiments import recipe_parser, run_dir, setup_device, write_json
from lmsu_tpu_torch.experiments.teacher_scaling import REGIME, _cache_gb


def _run(save, extra):
    return float(train_distill.main(REGIME + ["--save-dir", save] + extra))


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def main(argv=None) -> dict:
    p = recipe_parser(__doc__, "ta_chain_results.json", seeds=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--w4-teacher", default=None,
                   help="trained w=4 teacher (from the capacity-gap grid); default "
                   "<output-root>/checkpoints/capgap_tw4.0_s{seed}_teacher/best.pth")
    args, extra = p.parse_known_args(argv)
    setup_device(args)
    output = args.output or os.path.join(args.output_root, "ta_chain_results.json")
    w4 = (args.w4_teacher or os.path.join(run_dir(args, "capgap_tw4.0_s{seed}_teacher"),
                                          "best.pth")).format(seed=args.seed)
    if not os.path.exists(w4):
        raise FileNotFoundError(
            f"{w4} missing — run python -m lmsu_tpu_torch.experiments.capacity_gap first")
    tail = ["--device", args.device] + extra
    results = (_load(output) or {}).get("stages", {})

    ta_save = run_dir(args, f"ta_chain_ta_s{args.seed}")
    ta_ckpt = os.path.join(ta_save, "best.pth")
    if "ta" not in results or not os.path.exists(ta_ckpt):
        print("\n=== stage A: w=4 teacher -> w=1 TA ===", flush=True)
        results["ta"] = _run(ta_save, [
            "--seed", str(args.seed), "--teacher-width", "4", "--teacher-checkpoint", w4,
            "--cache-dtype", "bfloat16", "--cache-hbm-gb", _cache_gb(4.0)] + tail)
        _write(args, output, results)
    print(f"TA (w=1, from w=4 teacher): {results['ta']:.4f}")

    if "student" not in results:
        print("\n=== stage B: TA -> w=0.5 student ===", flush=True)
        results["student"] = _run(run_dir(args, f"ta_chain_student_s{args.seed}"), [
            "--seed", str(args.seed), "--width", "0.5", "--teacher-width", "1",
            "--teacher-checkpoint", ta_ckpt, "--cache-hbm-gb", _cache_gb(1.0)] + tail)
        _write(args, output, results)
    print(f"chained w=0.5 student: {results['student']:.4f}")

    grid = _load(os.path.join(args.output_root, "capacity_gap_results.json"))
    if grid is not None:
        print("\n=== vs direct distillation (capacity_gap_results.json) ===")
        for tw, r in sorted(grid["per_teacher_width"].items(), key=lambda t: float(t[0])):
            print(f"direct w{tw} -> 0.5: {r['student']:.4f}")
        print(f"chain  w4 -> 1 -> 0.5: {results['student']:.4f}")
    return _write(args, output, results)


def _write(args, output, results):
    tscale = _load(os.path.join(args.output_root, "teacher_scaling_results.json")) or {}
    w4_row = tscale.get("per_width", {}).get("4.0")
    payload = {
        "benchmark": "synthetic_hard",
        "config": {"regime": "kd_lift (400/512, 40ep)",
                   "recipe": "noisy-student KD, T=4, cached clean teacher targets",
                   "chain": "w4 teacher -> w1 TA -> w0.5 student",
                   "seed": args.seed},
        "direct_cells": "capacity_gap_results.json",
        "tscale_w4_student_committed": w4_row["student"] if w4_row else None,
        "stages": results}
    write_json(output, payload)
    return payload


if __name__ == "__main__":
    main()
