"""Shared CLI plumbing of the port's entry points (the JAX package's
scripts/common.py): the common flags, their overrides of a preset
ExperimentConfig, the loaders and resuming.

--dataset takes pandaset, synthetic and packed; without it the preset's
dataset holds (PandaSet for train_pandaset and train_fusion_ablation,
synthetic for train_synthetic, train_distill and evaluate). --data-root is
the PandaSet tree or the pack directory, --decoded-cache keeps decoded
PandaSet samples in host memory. --model-parallel N sets
MeshConfig.model_parallel: under torchrun the ranks form the 2-D
('data', 'model') mesh, over whose model axis the KD teacher is split
(parallel/tp.py); every other path replicates along it.
The port adds --device (CUDA unless 'cpu' is asked for) and --bf16.
--augment and --aug-* set TrainConfig.augment (ops/augment.py).

Data parallelism: run a trainer CLI under torchrun,
  torchrun --nproc-per-node N -m lmsu_tpu_torch.train_distill ...
`setup_mesh` makes the process group from torchrun's environment (one rank
a device, cuda:LOCAL_RANK; gloo with --device cpu) before the loaders,
which then decode this rank's stripe of every global --batch-size batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import torch

from lmsu_tpu_torch.config import AugmentConfig, ExperimentConfig

FUSION_TYPES = ("concat", "minimal", "weighted", "gated_sum")
SCATTER_IMPLS = ("xla", "xla_fastbwd", "sorted", "pallas", "sorted_pallas")
#: Each fusion's published output width (the host tools' models).
FUSION_CHANNELS = {"concat": 256, "minimal": 128, "weighted": 128, "gated_sum": 128}

#: Where the port's host tools and experiments write by default
#: (result JSONs, run directories, figures). Every default output of their
#: scripts/ counterparts is a file the JAX package keeps in git (the root
#: result JSONs, checkpoints/<run>/training_history.json,
#: docs/weighted_gate_analysis.json); the port's go under this root of its
#: own, which .gitignore lists, so a run with the defaults overwrites none
#: of them. Each tool and experiment takes --output-root to move it.
OUTPUT_ROOT = "torch_runs"


def import_pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a tool draws.
    Without matplotlib it raises, naming it: a tool asked for figures never
    skips them silently (the card's machine has no matplotlib; the tools'
    compute functions run there without it)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("drawing figures needs matplotlib, which is not installed "
                           "here; install it or run the tool where it is") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def device_label(device) -> str:
    """The device a measurement ran on, as the benches and experiments record
    it beside their numbers: for a CUDA device the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` gives them (the name
    alone where nvidia-smi cannot be read), else the device type."""
    import subprocess
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(index)


def add_output_root_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--output-root", default=OUTPUT_ROOT,
                   help="directory of every default output path (result JSON, run "
                   "directories, figures); default %(default)s")


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--data-root", default=None,
                   help="the PandaSet tree (scene directories), or with --dataset packed "
                   "the pack directory (train/ and val/); default DataConfig.root")
    p.add_argument("--dataset", default=None, choices=["pandaset", "synthetic", "packed"],
                   help="default: the preset's; 'packed' trains from packs written by "
                   "python -m lmsu_tpu_torch.prepare_dataset")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num-train", type=int, default=None, help="synthetic: #train samples")
    p.add_argument("--num-val", type=int, default=None)
    p.add_argument("--difficulty", default=None, choices=["easy", "hard"],
                   help="synthetic dataset difficulty: 'easy' saturates (plumbing "
                   "checks); 'hard' is the discriminative benchmark")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save-dir>/latest.pth if present")
    p.add_argument("--scan-steps", type=int, default=None,
                   help="chain K train (and val) steps per chunk: K batches stacked and "
                   "copied to the device in one transfer (TrainConfig.scan_steps)")
    p.add_argument("--onchip-epoch", action="store_true",
                   help="run each train epoch over a copy of the train set on the device "
                   "(TrainConfig.onchip_epoch)")
    p.add_argument("--onchip-eval", action="store_true",
                   help="require on-device validation too (default: follows "
                   "--onchip-epoch where the val loader allows it; TrainConfig.onchip_eval)")
    p.add_argument("--progress", action="store_true",
                   help="per-step progress bars on stderr")
    p.add_argument("--decoded-cache", action="store_true",
                   help="keep decoded PandaSet samples in host memory (~0.3 MB a sample): "
                   "later epochs decode nothing (DataConfig.decoded_cache)")
    p.add_argument("--num-workers", type=int, default=None,
                   help="per-sample decode threads in the input pipeline")
    p.add_argument("--lidar-encoder", default=None, choices=["spatial", "pointpillars"],
                   help="LiDAR encoder (LidarEncoderConfig.encoder_type)")
    p.add_argument("--fusion-type", default=None, choices=FUSION_TYPES,
                   help="override the script's fusion variant (single-run scripts; "
                   "the ablation sweep sets its own)")
    p.add_argument("--fusion-channels", type=int, default=None,
                   help="override ModelConfig.fusion_out_channels")
    p.add_argument("--scatter-impl", default=None, choices=SCATTER_IMPLS,
                   help="BEV scatter-max (LidarEncoderConfig.scatter_impl): 'xla' "
                   "scatter_reduce with autograd's backward; 'xla_fastbwd' the same "
                   "forward with the dense tie-splitting backward; 'sorted' sort + "
                   "segmented prefix max, dense backward; 'pallas' the unsorted "
                   "scatter-max kernel, dense backward; 'sorted_pallas' the "
                   "sorted-scatter kernels, and it also turns on the loaders' "
                   "by-cell point sort")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute, f32 parameters")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="size of a second ('model') mesh axis: builds a 2-D ('data','model') "
                   "mesh of the torchrun ranks; the KD teacher is tensor- or "
                   "spatially-partitioned over it (parallel/tp.py, "
                   "KDConfig.teacher_partition); other paths replicate. Not needed for "
                   "--teacher-partition fsdp, which shards teacher weight storage over "
                   "the data axis")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="clip gradients to this global L2 norm")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="keep an EMA of the parameters; validation, the best "
                   "checkpoint and evaluation use it")
    p.add_argument("--snapshot-every", type=int, default=None,
                   help="every N epochs also write an immutable epoch_###.pth "
                   "(TrainConfig.snapshot_every); each loads as a --teacher-checkpoint")
    p.add_argument("--handle-sigterm", action="store_true",
                   help="on SIGTERM finish the current epoch, write and flush latest.pth "
                   "and exit cleanly (TrainConfig.handle_sigterm)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints from a background thread "
                   "(TrainConfig.async_checkpoint)")
    p.add_argument("--augment", action="store_true",
                   help="the standard augmentation on the device: hflip 0.5, "
                   "brightness / contrast 0.1, image noise 0.02, point dropout 0.05 "
                   "(ops/augment.py; each term by --aug-*)")
    p.add_argument("--aug-hflip", type=float, default=None,
                   help="lateral mirror probability; an --aug-* flag without "
                   "--augment turns on that term alone")
    p.add_argument("--aug-brightness", type=float, default=None)
    p.add_argument("--aug-contrast", type=float, default=None)
    p.add_argument("--aug-image-noise", type=float, default=None)
    p.add_argument("--aug-point-dropout", type=float, default=None)
    p.add_argument("--aug-point-jitter-xy", type=float, default=None)
    p.add_argument("--aug-flip-image-mode", default=None, choices=["aligned", "mirror"],
                   help="'aligned' for top-down-aligned cameras (synthetic), 'mirror' "
                   "for perspective cameras")


#: The standard recipe --augment turns on (ops/augment.py; the flip needs a
#: scatter other than sorted_pallas, which check_augment_compat enforces).
STANDARD_AUGMENT = dict(enabled=True, hflip_prob=0.5, brightness=0.1, contrast=0.1,
                        image_noise_std=0.02, point_dropout=0.05)


def _augment_from_args(args) -> Optional[AugmentConfig]:
    """The AugmentConfig of --augment / --aug-* (None when none is given):
    --augment starts from STANDARD_AUGMENT, each --aug-* flag sets its term."""
    knobs = {"hflip_prob": args.aug_hflip, "brightness": args.aug_brightness,
             "contrast": args.aug_contrast, "image_noise_std": args.aug_image_noise,
             "point_dropout": args.aug_point_dropout,
             "point_jitter_xy": args.aug_point_jitter_xy,
             "flip_image_mode": args.aug_flip_image_mode}
    explicit = {k: v for k, v in knobs.items() if v is not None}
    if not args.augment and not explicit:
        return None
    base = dict(STANDARD_AUGMENT) if args.augment else {"enabled": True}
    return AugmentConfig(**{**base, **explicit})


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """`cfg` with every common flag that was given written into it."""
    def given(pairs):
        return {field: getattr(args, flag) for flag, field in pairs
                if getattr(args, flag) is not None}

    data_kw = given((("data_root", "root"), ("dataset", "dataset"), ("batch_size", "batch_size"),
                     ("num_train", "synthetic_num_train"), ("num_val", "synthetic_num_val"),
                     ("difficulty", "synthetic_difficulty"), ("num_workers", "num_workers")))
    if args.decoded_cache:
        data_kw["decoded_cache"] = True
    train_kw = given((("epochs", "num_epochs"), ("lr", "lr"), ("save_dir", "save_dir"),
                      ("seed", "seed"), ("grad_clip_norm", "grad_clip_norm"),
                      ("ema_decay", "ema_decay"), ("scan_steps", "scan_steps"),
                      ("snapshot_every", "snapshot_every")))
    for flag in ("onchip_epoch", "onchip_eval", "progress", "handle_sigterm",
                 "async_checkpoint"):
        if getattr(args, flag):
            train_kw[flag] = True
    aug = _augment_from_args(args)
    if aug is not None:
        train_kw["augment"] = aug
    model = cfg.model.replace(**given((("fusion_type", "fusion_type"),
                                       ("fusion_channels", "fusion_out_channels"))))
    if args.scatter_impl is not None:
        model = model.replace(lidar=dataclasses.replace(model.lidar,
                                                        scatter_impl=args.scatter_impl))
    if args.lidar_encoder is not None:
        model = model.replace(lidar=dataclasses.replace(model.lidar,
                                                        encoder_type=args.lidar_encoder))
    if args.bf16:
        model = model.replace(compute_dtype=torch.bfloat16)
    mesh = cfg.mesh
    if getattr(args, "model_parallel", None) is not None:
        mesh = dataclasses.replace(mesh, model_parallel=args.model_parallel)
    return cfg.replace(model=model, data=dataclasses.replace(cfg.data, **data_kw),
                       train=dataclasses.replace(cfg.train, **train_kw), mesh=mesh)


def setup_mesh(args, cfg: Optional[ExperimentConfig] = None):
    """The mesh of a rank started by torchrun (WORLD_SIZE set): the process
    group over NCCL on cuda:LOCAL_RANK, or gloo with --device cpu, 2-D
    with --model-parallel N > 1 (N must divide WORLD_SIZE);
    made before the loaders, which read their stripe from it, and the
    trainers, which run on it. None for a plain run (one device)."""
    from lmsu_tpu_torch.parallel.mesh import launched_distributed, make_mesh
    if not launched_distributed():
        return None
    return make_mesh(cfg.mesh if cfg is not None else None,
                     device=None if args.device == "cuda" else args.device)


def build_loaders(cfg: ExperimentConfig, verbose: bool = True):
    """Train/val loaders; the cell sort rides the decode workers when the
    sorted scatter is on (scripts/common.py::build_loaders)."""
    from lmsu_tpu_torch.data import create_datasets, make_loader
    from lmsu_tpu_torch.data.rasterize import make_point_sorter
    train_ds, val_ds = create_datasets(cfg.data, verbose=verbose)
    transform = None
    if cfg.model.lidar.scatter_impl == "sorted_pallas":
        transform = make_point_sorter(cfg.model.lidar.grid_size,
                                      cfg.model.lidar.point_cloud_range)
    train_loader = make_loader(train_ds, cfg.data.batch_size, shuffle=cfg.data.shuffle_train,
                               seed=cfg.train.seed, decode_workers=cfg.data.num_workers,
                               sample_transform=transform)
    val_loader = make_loader(val_ds, cfg.data.batch_size, shuffle=False,
                             decode_workers=cfg.data.num_workers, sample_transform=transform)
    if verbose:
        print(f"Dataset: {cfg.data.dataset} — {len(train_ds)} train / "
              f"{len(val_ds)} val samples")
    return train_loader, val_loader


def maybe_resume(trainer, cfg: ExperimentConfig, resume: bool) -> int:
    """The epoch to start from: after <save_dir>/latest.pth's when `resume`
    and the file exists, else 0."""
    from lmsu_tpu_torch.training.checkpoint import LATEST
    latest = os.path.join(cfg.train.save_dir, LATEST)
    if resume and os.path.exists(latest):
        return trainer.load_checkpoint(latest)
    return 0
