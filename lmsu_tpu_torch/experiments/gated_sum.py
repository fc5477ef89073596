"""Gated-sum fusion on the hard benchmark: does dropping the convexity
constraint close the weighted-fusion gap?

Counterpart of scripts/experiment_gated_sum.py. GatedSumFusion replaces
the weighted fusion's softmax with independent sigmoid gates (same
parameter count, 528,132 at /128; a function class containing both
minimal's add and weighted's mask). It trains gated_sum/128 in the seeded
ablation's regime (kd_lift: 400 / 512, 40 epochs, B=32, on-device epochs,
seeds 0-2), paired with the port's own seeded fusion ablation
(--baseline, default <output-root>/fusion_ablation_hard_seeded.json: per
seed the concat, minimal and weighted val mIoU); where that file is
missing the payload has no paired gaps, as in the script. A seed already
in the output is kept and retrained.

Usage:
  python -m lmsu_tpu_torch.experiments.gated_sum [--seeds 0 1 2] [--device cuda] \\
      [--baseline FILE] [--output-root torch_runs] [--output FILE] \\
      [--scatter-impl sorted_pallas]

Writes <output-root>/fusion_gated_sum_results.json; run directories are
<output-root>/checkpoints/gated_sum_s<seed>/. The other flags are the
common ones (lmsu_tpu_torch/common.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg, apply_overrides
from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from lmsu_tpu_torch.experiments import run_dir, setup_device, train_arm, write_json
from lmsu_tpu_torch.training import Trainer


def _base_config(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="gated_sum", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        synthetic_num_train=400, synthetic_num_val=512, batch_size=32),
        train=TrainConfig(num_epochs=40, class_weights=(0.4, 3.5), onchip_epoch=True,
                          save_dir=run_dir(args, "gated_sum")))
    return apply_overrides(cfg, args)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--output", default=None,
                   help="default <output-root>/fusion_gated_sum_results.json")
    p.add_argument("--baseline", default=None,
                   help="default <output-root>/fusion_ablation_hard_seeded.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    args.baseline = args.baseline or os.path.join(args.output_root,
                                                  "fusion_ablation_hard_seeded.json")
    output = args.output or os.path.join(args.output_root, "fusion_gated_sum_results.json")
    try:
        with open(output) as f:
            per_seed = json.load(f)["per_seed"]
    except FileNotFoundError:
        per_seed = {}

    base = _base_config(args)
    for seed in args.seeds:
        cfg = base.replace(train=dataclasses.replace(
            base.train, seed=seed, save_dir=run_dir(args, f"gated_sum_s{seed}")))
        print(f"\n=== seed {seed}: gated_sum/128 ===", flush=True)
        best, trainer = train_arm(cfg, Trainer, args.device)
        del trainer
        per_seed[str(seed)] = {"gated_sum": float(best)}
        write_json(output, _payload(per_seed, args))
        print(f"seed {seed}: gated_sum {float(best):.4f}")

    results = _payload(per_seed, args)
    print("\n=== gated_sum vs the seeded hard ablation (paired) ===")
    for s, r in sorted(results["per_seed"].items()):
        line = f"seed {s}: gated_sum {r['gated_sum']:.4f}"
        if "vs_weighted" in r:
            line += (f"  (vs weighted {r['vs_weighted']:+.4f}, vs minimal "
                     f"{r['vs_minimal']:+.4f}, vs concat {r['vs_concat']:+.4f})")
        print(line)
    if "gap_vs_weighted_mean" in results:
        print(f"vs weighted: mean {results['gap_vs_weighted_mean']:+.4f}, "
              f"min {results['gap_vs_weighted_min']:+.4f}")
    return results


def _payload(per_seed, args):
    out = {"benchmark": "synthetic_hard",
           "experiment": "gated_sum_fusion",
           "config": {"regime": "kd_lift (400/512, 40ep, onchip)",
                      "model": "gated_sum/128 (528,132 params)",
                      "paired_baselines": args.baseline,
                      "seeds": sorted(int(s) for s in per_seed)},
           "per_seed": {s: dict(r) for s, r in per_seed.items()}}
    try:
        with open(args.baseline) as f:
            base = json.load(f)["per_seed"]
    except FileNotFoundError:
        base = {}
    gaps_w = []
    for s, r in out["per_seed"].items():
        if s in base:
            for k in ("weighted", "minimal", "concat"):
                r[f"vs_{k}"] = round(r["gated_sum"] - base[s][k], 4)
            gaps_w.append(r["vs_weighted"])
    if gaps_w:
        out["gap_vs_weighted_mean"] = round(sum(gaps_w) / len(gaps_w), 4)
        out["gap_vs_weighted_min"] = round(min(gaps_w), 4)
        out["beats_weighted_every_seed"] = bool(min(gaps_w) > 0)
    vals = [r["gated_sum"] for r in per_seed.values()]
    out["mean_miou"] = round(sum(vals) / len(vals), 4)
    return out


if __name__ == "__main__":
    main()
