"""Accuracy-level check of the cached-teacher KD path: the same student
distilled with the teacher in the step (in-loop) and from the dataset-wide
teacher cache (cached), in one process.

Counterpart of scripts/experiment_kd_cache_equiv.py. It trains kd_lift's
teacher (same configuration and seed; skipped when --teacher-checkpoint
names an existing file), then the in-loop and the cached student arms.
kd_lift's regime runs the on-device epoch (TrainConfig.onchip_epoch), and
the cached arm's cache rides it, on the device under a 6 GiB budget (the 2x
teacher's f32 taps of 400 samples take 5.05 GB): the experiment refuses a
cached arm whose trainer built no device cache, which would make the
comparison vacuous.

Usage:
  python -m lmsu_tpu_torch.experiments.kd_cache_equiv [--seed 0] [--device cuda] \\
      [--teacher-checkpoint <teacher>.pth] [--output-root torch_runs] [--output FILE] [...]

Writes <output-root>/kd_cache_equiv.json (the script's schema).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from lmsu_tpu_torch.common import add_common_args, add_output_root_arg
from lmsu_tpu_torch.config import KDConfig, teacher_config
from lmsu_tpu_torch.experiments import (add_kernel_args, run_dir, setup_device, train_arm,
                                        write_json)
from lmsu_tpu_torch.experiments.kd_lift import _base_config
from lmsu_tpu_torch.training import DistillationTrainer, Trainer


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    add_kernel_args(p)
    p.add_argument("--teacher-checkpoint", default=None)
    p.add_argument("--output", default=None, help="default <output-root>/kd_cache_equiv.json")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    seed = args.seed if args.seed is not None else 0
    base = _base_config(args)

    tck = args.teacher_checkpoint
    if tck is None or not os.path.exists(tck):
        # The teacher arm, exactly as kd_lift.run_seed trains it.
        tcfg = base.replace(model=teacher_config(base.model, 2.0), train=dataclasses.replace(
            base.train, seed=seed, save_dir=run_dir(args, f"kd_lift_teacher_s{seed}")))
        t_best, _ = train_arm(tcfg, Trainer, args.device)
        print(f"teacher (seed {seed}): best val mIoU {t_best:.6f}")
        tck = os.path.join(tcfg.train.save_dir, "latest.pth")

    results, times = {}, {}
    for arm, cached in (("inloop", False), ("cached", True)):
        kd = KDConfig(enabled=True, temperature=2.0, alpha_kl=0.5, beta_feature=0.5,
                      teacher_width_mult=2.0, teacher_checkpoint=tck, cache_teacher=cached,
                      # Keep the cache on the device: the on-device epoch
                      # refuses the host-spilled cache.
                      cache_hbm_limit_bytes=6 << 30, use_pallas=args.use_pallas_kd)
        cfg = base.replace(train=dataclasses.replace(
            base.train, seed=seed, kd=kd, save_dir=run_dir(args, f"kd_lift_student_kd{arm}_s{seed}")))
        t0 = time.perf_counter()
        best, trainer = train_arm(cfg, DistillationTrainer, args.device)
        results[arm] = float(best)
        times[arm] = round(time.perf_counter() - t0, 1)
        if cached and trainer.teacher_cache is None:
            raise RuntimeError("the cached arm built no device teacher cache: the comparison "
                               "would be vacuous")
        print(f"student_kd[{arm}]: best val mIoU {results[arm]:.6f} ({times[arm]}s)")

    out = {"seed": seed,
           "onchip_epoch": bool(base.train.onchip_epoch),
           "student_kd_inloop": results["inloop"],
           "student_kd_cached": results["cached"],
           "abs_diff": abs(results["cached"] - results["inloop"]),
           "train_wall_s": times,
           "note": ("the cached arm rides the on-device epoch with the teacher cache on the "
                    "device (the experiment checks that the cache exists)")}
    write_json(args.output or os.path.join(args.output_root, "kd_cache_equiv.json"), out)
    print(f"\nin-loop {results['inloop']:.6f}  cached {results['cached']:.6f}  "
          f"|diff| {out['abs_diff']:.2e}")
    return out


if __name__ == "__main__":
    main()
