"""Augmentation-lift experiment on the hard synthetic benchmark, seeded:
what the device-side augmentation (ops/augment.py) buys at the accuracy
level, and whether it compounds with KD, in kd_lift's low-data regime
(weighted/128 student, 400 train / 512 val, 40 epochs, the on-device
epoch), paired per seed with kd_lift's arms.

Counterpart of scripts/experiment_augment.py. Arms per seed (all share the
seed's data order and init streams):
  1. teacher        the 2x-wide model, labels only (retrained here; its
                    best.pth is what augment_noisy and best_recipe read);
  2. student_aug    the standard model under the standard augmentation
                    (common.STANDARD_AUGMENT: hflip 0.5, brightness /
                    contrast 0.1, noise 0.02, point dropout 0.05);
  3. student_kd_aug distilled from THIS seed's teacher, in-loop (the flip
                    forbids the teacher cache), same augmentation.
The plain student and student+KD come from kd_lift's results
(--baselines, the port's <output-root>/kd_comparison_results.json) when
their regime matches, else (or with --rerun-baselines) they are trained
here.

Usage:
  python -m lmsu_tpu_torch.experiments.augment [--seeds 0 1 2] [--device cuda] \\
      [--teacher-width 2] [--baselines FILE] [--rerun-baselines] \\
      [--output-root torch_runs] [--output FILE] \\
      [--scatter-impl pallas] [--use-pallas-fusion] [--use-pallas-kd]

The flip and the point dropout move points, so the augmented arms refuse
--scatter-impl sorted_pallas (ops/augment.py::check_augment_compat).
Writes <output-root>/augment_results.json (the script's schema, with the
paired gaps aug_gap, kd_aug_gap and aug_on_top_of_kd); run directories are
<output-root>/checkpoints/augment_<arm>_s<seed>/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import (STANDARD_AUGMENT, add_common_args, add_output_root_arg,
                                   apply_overrides)
from lmsu_tpu_torch.config import (AugmentConfig, DataConfig, ExperimentConfig, KDConfig,
                                   ModelConfig, TrainConfig, teacher_config)
from lmsu_tpu_torch.experiments import (add_kernel_args, run_dir, setup_device, train_arm,
                                        with_fusion_kernel, write_json)
from lmsu_tpu_torch.training import DistillationTrainer, Trainer


def _base_config(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        synthetic_num_train=400, synthetic_num_val=512, batch_size=32),
        train=TrainConfig(num_epochs=40, class_weights=(0.4, 3.5), onchip_epoch=True,
                          save_dir=run_dir(args, "augment")))
    return with_fusion_kernel(apply_overrides(cfg, args), args)


def _kd(args) -> KDConfig:
    return KDConfig(enabled=True, teacher_width_mult=args.teacher_width,
                    use_pallas=args.use_pallas_kd)


def _load_baselines(args):
    """Per-seed student / student_kd from kd_lift's results when their
    regime matches this run's; None forces a rerun."""
    if args.rerun_baselines or not os.path.exists(args.baselines):
        return None
    with open(args.baselines) as f:
        prior = json.load(f)
    base = _base_config(args)
    want = {"num_train": base.data.synthetic_num_train,
            "num_val": base.data.synthetic_num_val,
            "epochs": base.train.num_epochs,
            "batch_size": base.data.batch_size}
    got = {k: prior.get("config", {}).get(k) for k in want}
    if got != want or prior.get("benchmark") != "synthetic_hard":
        print(f"baselines config mismatch ({got} != {want}); re-running")
        return None
    return prior["per_seed"]


def run_seed(seed: int, args, baselines) -> dict:
    base = _base_config(args)
    aug = AugmentConfig(**STANDARD_AUGMENT)
    out = {}

    def arm(name, **train_kw):
        return base.replace(train=dataclasses.replace(
            base.train, seed=seed, save_dir=run_dir(args, f"augment_{name}_s{seed}"),
            **train_kw))

    # -- 1. teacher (plain) ---------------------------------------------------
    tcfg = arm("teacher").replace(model=teacher_config(base.model, args.teacher_width))
    print(f"\n=== seed {seed}: teacher ===", flush=True)
    out["teacher"], t_trainer = train_arm(tcfg, Trainer, args.device)
    teacher_sd = {k: v.detach().cpu() for k, v in t_trainer.model.state_dict().items()}
    del t_trainer

    # -- baselines (reused or rerun) -----------------------------------------
    if baselines is not None and str(seed) in baselines:
        out["student"] = baselines[str(seed)]["student"]
        out["student_kd"] = baselines[str(seed)]["student_kd"]
        out["baselines_reused"] = True
    else:
        print(f"\n=== seed {seed}: student (plain) ===", flush=True)
        out["student"], _ = train_arm(arm("student"), Trainer, args.device)
        print(f"\n=== seed {seed}: student+KD (plain) ===", flush=True)
        out["student_kd"], _ = train_arm(arm("student_kd", kd=_kd(args)), DistillationTrainer,
                                         args.device, teacher_state_dict=teacher_sd)
        out["baselines_reused"] = False

    # -- 2. student + augmentation ---------------------------------------------
    print(f"\n=== seed {seed}: student + augment ===", flush=True)
    out["student_aug"], _ = train_arm(arm("student_aug", augment=aug), Trainer, args.device)

    # -- 3. student + KD + augmentation (in-loop teacher) ----------------------
    print(f"\n=== seed {seed}: student + KD + augment ===", flush=True)
    out["student_kd_aug"], _ = train_arm(arm("student_kd_aug", augment=aug, kd=_kd(args)),
                                         DistillationTrainer, args.device,
                                         teacher_state_dict=teacher_sd)

    print(f"\nseed {seed}: teacher {out['teacher']:.4f}  "
          f"student {out['student']:.4f}  aug {out['student_aug']:.4f}  "
          f"kd {out['student_kd']:.4f}  kd+aug {out['student_kd_aug']:.4f}", flush=True)
    return out


def summarize(per_seed: dict, args) -> dict:
    arms = ("teacher", "student", "student_aug", "student_kd", "student_kd_aug")
    mean = {a: sum(r[a] for r in per_seed.values()) / len(per_seed) for a in arms}
    gaps = {
        "aug_gap": {s: r["student_aug"] - r["student"] for s, r in per_seed.items()},
        "kd_aug_gap": {s: r["student_kd_aug"] - r["student"] for s, r in per_seed.items()},
        "aug_on_top_of_kd": {s: r["student_kd_aug"] - r["student_kd"]
                             for s, r in per_seed.items()},
    }
    base = _base_config(args)
    results = {
        "benchmark": "synthetic_hard",
        "config": {"num_train": base.data.synthetic_num_train,
                   "num_val": base.data.synthetic_num_val,
                   "epochs": base.train.num_epochs,
                   "batch_size": base.data.batch_size,
                   "teacher_width": args.teacher_width,
                   "augment": dict(STANDARD_AUGMENT),
                   "seeds": sorted(int(s) for s in per_seed)},
        "per_seed": per_seed,
        "mean_miou": {a: round(mean[a], 4) for a in arms},
    }
    for name, g in gaps.items():
        results[name + "_per_seed"] = {s: round(v, 4) for s, v in g.items()}
        results[name + "_mean"] = round(sum(g.values()) / len(g), 4)
        results[name + "_min"] = round(min(g.values()), 4)

    print("\n=== augmentation lift (hard synthetic benchmark) ===")
    print(f"{'arm':>16s} {'mean mIoU':>10s}   per-seed")
    for a in arms:
        vals = " ".join(f"{per_seed[s][a]:.4f}" for s in sorted(per_seed))
        print(f"{a:>16s} {mean[a]:10.4f}   {vals}")
    for name, g in gaps.items():
        print(f"{name}: mean {results[name + '_mean']:+.4f}, "
              f"min {results[name + '_min']:+.4f}  per-seed "
              + " ".join(f"{g[s]:+.4f}" for s in sorted(g)))
    return results


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--teacher-width", type=float, default=2.0)
    p.add_argument("--baselines", default=None,
                   help="kd_lift's results to pair with; default "
                   "<output-root>/kd_comparison_results.json")
    p.add_argument("--rerun-baselines", action="store_true",
                   help="retrain plain student / student+KD instead of reusing "
                   "kd_lift's results")
    p.add_argument("--output", default=None, help="default <output-root>/augment_results.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    args.baselines = args.baselines or os.path.join(args.output_root,
                                                    "kd_comparison_results.json")
    output = args.output or os.path.join(args.output_root, "augment_results.json")
    baselines = _load_baselines(args)
    per_seed = {}
    for seed in args.seeds:
        per_seed[str(seed)] = run_seed(seed, args, baselines)
        # Incremental dump: a crash in a later seed keeps finished arms.
        write_json(output + ".partial", per_seed)

    results = summarize(per_seed, args)
    write_json(output, results)
    print(f"Wrote {output}")
    return results


if __name__ == "__main__":
    main()
