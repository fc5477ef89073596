"""The experiments of scripts/experiment_*.py, on the port.

Each experiment runs as `python -m lmsu_tpu_torch.experiments.<name>` (the
script's name less `experiment_`) with its script's flags, arms, grids,
regimes and result-JSON schema:
  kd_lift         teacher / student / student+KD per seed (kd_comparison_results.json)
  kd_sweep        KD temperature and loss-weight grid from kd_lift's teacher
  kd_cache_equiv  in-loop against cached teacher, accuracy-level
  kd_compression  students of width 0.5 and 0.25 from kd_lift's teacher
  kd_crossarch    spatial teacher -> PointPillars student per seed
  best_overall    the best recipe on minimal/128, through train_distill
  crossarch_best  the best recipe, spatial teacher -> PointPillars student
  kd_ensemble     a two-member ensemble teacher under the best recipe
  augment         the augmentation lift, with and without KD, paired with kd_lift
  augment_noisy   noisy-student KD from augment's teachers (cached clean teacher)
  best_recipe     noisy-student KD at T=4 from augment's teachers
  teacher_scaling the best recipe at teacher widths 1 and 4 (train_distill)
  capacity_gap    a half-width student from teachers of width 1, 2, 4 (train_distill)
  ta_chain        w=4 teacher -> w=1 assistant -> w=0.5 student (train_distill)
  ema             EMA weights, with and without augmentation (train_synthetic)
  gated_sum       the gated-sum fusion, paired with a seeded fusion ablation
  quant_accuracy  int8 against float val mIoU on a trained model

What the port adds to each:
  * --device (CUDA unless 'cpu' is asked for), as the port's CLIs;
  * --output-root (common.OUTPUT_ROOT, torch_runs/): every default output
    (the result JSON, the run directories checkpoints/<run>/, the paired
    baselines and the teachers other experiments read) sits under it. The
    scripts' defaults are files the JAX package keeps in git (root result
    JSONs, checkpoints/<run>/training_history.json), and the experiments that
    read results (kd_sweep, kd_compression, crossarch_best, kd_ensemble and
    all of the second group but quant_accuracy) pair with the port's own runs,
    never with the TPU's;
  * kernel opt-ins, off by default so the arms' configurations equal the
    scripts': --scatter-impl (a common flag), --use-pallas-fusion and
    --use-pallas-kd on the experiments that build their configurations
    (quant_accuracy: --use-pallas-fusion and --fused-inference), and, on those
    that drive train_distill or train_synthetic, any further flag of that CLI,
    appended after the recipe's (the last of a repeated flag wins).
Checkpoints are the port's torch files (latest.pth, best.pth); a teacher
trained in the same process goes to the student's DistillationTrainer as
`teacher_state_dict=`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

from lmsu_tpu_torch.common import add_output_root_arg, build_loaders
from lmsu_tpu_torch.config import ExperimentConfig


def add_kernel_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--use-pallas-fusion", action="store_true",
                   help="run the weighted-fusion gate through its kernel")
    p.add_argument("--use-pallas-kd", action="store_true",
                   help="run the KD feature matching through its kernel")


def with_fusion_kernel(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """`cfg` with the gate kernel on when --use-pallas-fusion asks."""
    if not args.use_pallas_fusion:
        return cfg
    return cfg.replace(model=cfg.model.replace(use_pallas_fusion=True))


def run_dir(args, name: str) -> str:
    """The run directory `name` (the script's checkpoints/<name>) under
    --output-root."""
    return os.path.join(args.output_root, "checkpoints", name)


def setup_device(args) -> None:
    """Refuse a missing GPU unless --device cpu, and keep f32 at full
    precision on the card, as the port's CLIs do."""
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    resolve_device(args.device)
    pin_f32_precision()


def train_arm(cfg: ExperimentConfig, trainer_cls, device, **trainer_kw) -> Tuple[float, object]:
    """(best val mIoU, trainer) of one arm trained from its own loaders."""
    train_loader, val_loader = build_loaders(cfg)
    trainer = trainer_cls(cfg, train_loader, val_loader, device=device, **trainer_kw)
    return trainer.train(), trainer


def teacher_best(run: str) -> float:
    """The best val mIoU in a run directory's training_history.json."""
    with open(os.path.join(run, "training_history.json")) as f:
        return max(json.load(f)["val_miou"])


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def recipe_parser(doc: str, output: str, seeds: bool = True) -> argparse.ArgumentParser:
    """The flags of an experiment that runs train_distill's recipe: --seeds
    (with `seeds`), --output (default <output-root>/`output`), --output-root
    and --device. parse_known_args leaves every other flag for
    train_distill; abbreviations are off, so none of them is taken for one
    of these (--seed is not --seeds)."""
    p = argparse.ArgumentParser(description=doc, allow_abbrev=False,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    if seeds:
        p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--output", default=None, help=f"default <output-root>/{output}")
    add_output_root_arg(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def read_per_seed(path: str) -> dict:
    """The per_seed results already in `path` (a rerun resumes them), else {}."""
    try:
        with open(path) as f:
            return json.load(f)["per_seed"]
    except FileNotFoundError:
        return {}
