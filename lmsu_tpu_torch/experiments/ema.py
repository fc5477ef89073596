"""EMA-weight probe on the hard synthetic benchmark: what
TrainConfig.ema_decay buys at the accuracy level in kd_lift's regime
(weighted/128 student, 400 train / 512 val, 40 epochs), paired with the
port's augment arms of the same seeds.

Counterpart of scripts/experiment_ema.py. Arms per seed, each through
`lmsu_tpu_torch.train_synthetic.main` (the public CLI): student+EMA and
student+augment+EMA. The plain student and student+aug come from the
port's augment results (--baselines, default
<output-root>/augment_results.json) where they exist.

Usage:
  python -m lmsu_tpu_torch.experiments.ema [--seeds 0] [--ema-decay 0.99] \\
      [--device cuda] [--baselines FILE] [--output-root torch_runs] [--output FILE] \\
      [train_synthetic flags ...]

Further flags go to train_synthetic after the regime's (e.g.
--scatter-impl pallas, --epochs 1). Writes <output-root>/ema_results.json;
run directories are <output-root>/checkpoints/ema_student[_aug]_s<seed>/.
"""

from __future__ import annotations

import json
import os

from lmsu_tpu_torch import train_synthetic
from lmsu_tpu_torch.experiments import recipe_parser, run_dir, setup_device, write_json

REGIME = ["--fusion-type", "weighted", "--fusion-channels", "128",
          "--difficulty", "hard", "--num-train", "400", "--num-val", "512",
          "--epochs", "40", "--batch-size", "32", "--onchip-epoch"]


def main(argv=None) -> dict:
    p = recipe_parser(__doc__, "ema_results.json")
    p.set_defaults(seeds=[0])
    p.add_argument("--ema-decay", type=float, default=0.99)
    p.add_argument("--baselines", default=None,
                   help="default <output-root>/augment_results.json")
    args, extra = p.parse_known_args(argv)
    setup_device(args)
    output = args.output or os.path.join(args.output_root, "ema_results.json")
    baselines = {}
    try:
        with open(args.baselines or os.path.join(args.output_root,
                                                 "augment_results.json")) as f:
            baselines = json.load(f)["per_seed"]
    except (FileNotFoundError, KeyError):
        pass

    per_seed = {}
    for seed in args.seeds:
        row = {}
        if str(seed) in baselines:
            row["student"] = baselines[str(seed)].get("student")
            row["student_aug"] = baselines[str(seed)].get("student_aug")
        tail = ["--device", args.device] + extra
        print(f"\n=== seed {seed}: student + EMA({args.ema_decay}) ===", flush=True)
        row["student_ema"] = train_synthetic.main(
            REGIME + ["--seed", str(seed), "--ema-decay", str(args.ema_decay),
                      "--save-dir", run_dir(args, f"ema_student_s{seed}")] + tail)
        print(f"\n=== seed {seed}: student + augment + EMA ===", flush=True)
        row["student_aug_ema"] = train_synthetic.main(
            REGIME + ["--seed", str(seed), "--augment", "--ema-decay", str(args.ema_decay),
                      "--save-dir", run_dir(args, f"ema_student_aug_s{seed}")] + tail)
        per_seed[str(seed)] = row
        write_json(output + ".partial", per_seed)

    results = {"benchmark": "synthetic_hard",
               "config": {"regime": "kd_lift (400/512, 40ep, weighted/128)",
                          "ema_decay": args.ema_decay,
                          "seeds": sorted(int(s) for s in per_seed)},
               "per_seed": per_seed}
    for s, r in sorted(per_seed.items()):
        msg = f"seed {s}: student+EMA {r['student_ema']:.4f}"
        if r.get("student") is not None:
            msg += f" (plain {r['student']:.4f}, gap {r['student_ema'] - r['student']:+.4f})"
        msg += f"; aug+EMA {r['student_aug_ema']:.4f}"
        if r.get("student_aug") is not None:
            msg += (f" (aug {r['student_aug']:.4f}, gap "
                    f"{r['student_aug_ema'] - r['student_aug']:+.4f})")
        print(msg)
    write_json(output, results)
    print(f"Wrote {output}")
    return results


if __name__ == "__main__":
    main()
