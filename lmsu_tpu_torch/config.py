"""Configuration of the PyTorch port: the same dataclasses, fields and
defaults as the JAX package's config, with `compute_dtype` a `torch.dtype`.

Defaults of record (reference file:line):
  image 256x256                         pandaset_dataset.py:56
  BEV grid 64x64, pc_range +-50 m       pandaset_dataset.py:57,66
  max_points 5000                       pandaset_dataset.py:58
  lidar pc range [-50,-50,-5,50,50,3]   lidar_encoder.py:12

The port serves and trains (CE and KD) the four fusions with either head
and either LiDAR encoder (spatial, PointPillars), with stage remat,
augmentation on the device, teacher ensembles, the dataset-wide teacher
cache, chained steps, on-device epochs and run control (async and
snapshot checkpoints, SIGTERM preemption, debug_nans, progress bars).
Fields that select paths the port does not have yet (parallelism,
teacher partitioning) are kept so configurations stay interchangeable;
the trainers reject them by name.

Training defaults of record (reference file:line):
  lr 1e-3, weight_decay 1e-3            trainer.py:42
  batch 4, cosine eta_min 1e-5          trainer.py:59-61
  class weights [0.4, 3.5] (2-class)    train_with_fusion_ablation.py:47
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class CameraEncoderConfig:
    """TwinLite-style lightweight CNN (reference: camera_encoder.py:56-123)."""

    in_channels: int = 3
    base_channels: int = 32
    return_multiscale: bool = True
    # Width multiplier lets the same definition serve as a larger KD teacher.
    width_mult: float = 1.0
    # Training-only: rematerialise each InvertedResidual stage's activations
    # in the backward pass (models/layers.py::remat).
    remat: bool = False
    # Eval-mode forwards run each InvertedResidual stage as ONE hand-written
    # CUDA kernel (ops/ir_fused.py): BN running stats fold to scale/bias and
    # the 6x-expanded hidden activations stay in shared memory.
    fused_inference: bool = False
    # Train-mode forwards run each InvertedResidual stage through the fused
    # training kernels (ops/ir_fused.py::fused_ir_train, K8-K13): batch
    # statistics in f32, the expanded hidden tensor recomputed from x in the
    # backward instead of stored.
    fused_train: bool = False

    @property
    def channels(self) -> Tuple[int, int, int]:
        b = int(round(self.base_channels * self.width_mult))
        return (b, b * 2, b * 4)


@dataclass(frozen=True)
class LidarEncoderConfig:
    """PointNet-style BEV encoder (reference: lidar_encoder.py:9-41)."""

    encoder_type: str = "spatial"
    input_dim: int = 4
    feature_dim: int = 128
    grid_size: Tuple[int, int] = (64, 64)
    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        -50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    mlp_dims: Tuple[int, ...] = (64, 128)
    # BEV scatter-max algorithm, the JAX package's five names, so one
    # configuration selects the same path in both packages:
    #   "xla"           plain scatter_reduce, autograd's backward (ops/scatter.py);
    #   "xla_fastbwd"   the same forward, the dense tie-splitting backward;
    #   "sorted"        sort + segmented prefix max + lookup, points in any
    #                   order, dense backward (plain PyTorch, ops/scatter.py);
    #   "pallas"        the unsorted scatter-max kernel, dense backward
    #                   (ops/voxelize.py);
    #   "sorted_pallas" the sorted-input segment-max kernels
    #                   (ops/scatter_sorted.py); REQUIRES points pre-sorted by
    #                   BEV cell, which the Predictor, the serving engine and
    #                   the training loaders do on the host
    #                   (data/rasterize.py::make_point_sorter) for this value
    #                   only.
    scatter_impl: str = "xla"
    # Deprecated alias: True selects scatter_impl="pallas", whatever
    # scatter_impl says (as in the JAX package).
    use_pallas: bool = False
    width_mult: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    """Complete fusion segmentation model (reference: fusion_module.py:179-232)."""

    num_classes: int = 2
    fusion_type: str = "concat"
    fusion_out_channels: int = 256
    camera_fpn_channels: int = 128
    camera_fpn_stages: Optional[Tuple[str, ...]] = ("stage3", "stage4", "stage5")
    output_mode: str = "same"
    # Route the weighted-fusion gate through the fused kernel
    # (ops/fusion_gate.py) instead of the unfused softmax ops.
    use_pallas_fusion: bool = False
    camera: CameraEncoderConfig = field(default_factory=CameraEncoderConfig)
    lidar: LidarEncoderConfig = field(default_factory=LidarEncoderConfig)
    # Activation dtype (torch.float32 or torch.bfloat16); parameters stay fp32.
    compute_dtype: torch.dtype = torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def teacher_config(student: ModelConfig, width_mult: float = 2.0) -> ModelConfig:
    """A wider variant of the student used as the KD teacher."""
    return student.replace(
        camera=dataclasses.replace(student.camera, width_mult=width_mult),
        lidar=dataclasses.replace(
            student.lidar,
            feature_dim=int(student.lidar.feature_dim * width_mult),
            mlp_dims=tuple(int(d * width_mult) for d in student.lidar.mlp_dims),
            width_mult=width_mult,
        ),
        camera_fpn_channels=int(student.camera_fpn_channels * width_mult),
        fusion_out_channels=int(student.fusion_out_channels * width_mult),
    )


@dataclass(frozen=True)
class DataConfig:
    """Dataset + host input pipeline (reference: pandaset_dataset.py:48-157;
    the JAX package's DataConfig, same fields and defaults).

    `dataset` is "pandaset" (a scene tree under `root`, data/pandaset.py),
    "synthetic" (data/synthetic.py) or "packed" (pre-decoded arrays written
    once by `python -m lmsu_tpu_torch.prepare_dataset`, data/packed.py;
    `root` is the pack directory with train/ and val/ packs, and decode at
    train time costs a few copies). Sizes are (H, W) everywhere; the
    reference hands its image_size to PIL as (W, H), which is the same at
    the default 256x256."""

    root: str = "data/pandaset"
    dataset: str = "synthetic"
    image_size: Tuple[int, int] = (256, 256)
    grid_size: Tuple[int, int] = (64, 64)
    max_points: int = 5000
    pc_range: Tuple[float, float, float, float] = (-50.0, 50.0, -50.0, 50.0)
    batch_size: int = 4
    shuffle_train: bool = True
    num_workers: int = 2
    train_fraction: float = 0.8    # PandaSet: the first 80% of sorted scenes train
    synthetic_num_train: int = 800
    synthetic_num_val: int = 200
    synthetic_difficulty: str = "easy"
    # Reference quirk (pandaset_dataset.py:124-126): zero-padded points pass
    # the validity mask and land at the grid centre. Off by default: padded
    # points are marked invalid in point_valid.
    pad_points_are_valid: bool = False
    # PandaSet decoded-sample RAM cache (~0.3 MB a sample): epoch 1 decodes,
    # later epochs read host memory. Sound because a sample's decode is
    # deterministic per (seed, index) (data/pandaset.py). For no decode from
    # epoch 1 on, write packs and use dataset="packed".
    decoded_cache: bool = False


@dataclass(frozen=True)
class AugmentConfig:
    """Training augmentation on the device (the JAX package's AugmentConfig;
    ops/augment.py). Every term runs inside the train step, on the batch
    already on the device, with randomness keyed by (seed ^ seed_offset,
    step), so a resume at step k reproduces the stream. Validation is never
    augmented.

    `hflip_prob` mirrors the world laterally (x -> x_min + x_max - x) in the
    image, the points and the BEV labels; the labels map cell c to W-2-c
    (ops/augment.py::flip_bev_labels), the "aligned" image flip shifts by
    one BEV cell to match, "mirror" is a plain mirror for perspective
    cameras.

    Compatibility rules (ops/augment.py::check_augment_compat, at trainer
    build): terms that move or drop points (hflip, point_dropout,
    point_jitter_xy) break the pre-sorted input of
    scatter_impl="sorted_pallas"; hflip breaks KDConfig.cache_teacher (the
    cached taps are maps of the unflipped world). Photometric terms, point
    dropout and z / intensity jitter compose with the cache as noisy-student
    KD: targets from clean inputs, the student sees the augmented batch."""

    enabled: bool = False
    hflip_prob: float = 0.0
    flip_image_mode: str = "aligned"
    brightness: float = 0.0        # per-sample additive delta ~ U(-b, b)
    contrast: float = 0.0          # per-sample scale exp(U(-c, c)) about the mean
    image_noise_std: float = 0.0   # per-pixel gaussian noise
    point_dropout: float = 0.0     # per-point drop probability
    point_jitter_xy: float = 0.0   # gaussian std on x / y (metres)
    point_jitter_z: float = 0.0    # gaussian std on z (metres)
    intensity_jitter: float = 0.0  # gaussian std on intensity
    seed_offset: int = 0x5EED      # decorrelates the augmentation stream from init

    @property
    def moves_points(self) -> bool:
        """True if a term changes points' cells or validity (refused with
        the sorted_pallas input contract)."""
        return self.hflip_prob > 0 or self.point_dropout > 0 or self.point_jitter_xy > 0

    @property
    def spatial(self) -> bool:
        """True if a term moves scene geometry (refused with the cache)."""
        return self.hflip_prob > 0


@dataclass(frozen=True)
class KDConfig:
    """Teacher->student distillation loss (JAX package: config.py KDConfig).

    Ensembles: `teacher_checkpoints` (the port's .pth files, one per member)
    or `ensemble_size` random members present as one teacher with
    member-averaged logits and taps (training/distill.py::EnsembleTeacher).
    `cache_teacher` computes the frozen teacher's outputs once over the
    training set, gathered per step by sample index; the cache lives on the
    device up to `cache_hbm_limit_bytes` and spills to host memory above it;
    `cache_dtype` "auto" stores it in the compute dtype, "bfloat16" halves
    it. Teacher partitioning other than the single-device default ("sp",
    "fsdp") is refused by `training.DistillationTrainer`. `use_pallas`
    routes the feature-matching loss through the hand-written kernel
    (ops/kd_loss.py); the name is the JAX package's."""

    enabled: bool = False
    temperature: float = 2.0
    alpha_kl: float = 0.5
    beta_feature: float = 0.5
    feature_taps: Tuple[str, ...] = ("camera_feat", "lidar_feat", "post_fusion")
    teacher_width_mult: float = 2.0
    teacher_checkpoint: Optional[str] = None
    teacher_checkpoints: Optional[Tuple[str, ...]] = None
    ensemble_size: int = 1
    use_pallas: bool = False
    cache_teacher: bool = False
    cache_hbm_limit_bytes: int = 4 << 30
    cache_dtype: str = "auto"
    teacher_partition: str = "tp"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop (reference: trainer.py:40-74), with the JAX
    package's loop and run-control options (training/trainer.py)."""

    lr: float = 1e-3
    weight_decay: float = 1e-3
    num_epochs: int = 20
    eta_min: float = 1e-5
    grad_clip_norm: Optional[float] = None
    ema_decay: Optional[float] = None
    class_weights: Optional[Tuple[float, ...]] = (0.4, 3.5)
    ignore_index: int = -1
    save_dir: str = "checkpoints/run"
    snapshot_every: Optional[int] = None
    handle_sigterm: bool = False
    async_checkpoint: bool = False
    seed: int = 0
    metrics_num_classes: int = 2
    debug_nans: bool = False
    scan_steps: int = 1
    onchip_epoch: bool = False
    onchip_eval: Optional[bool] = None
    onchip_contiguous: bool = False
    progress: bool = False
    kd: KDConfig = field(default_factory=KDConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh of the JAX package. The port trains on one device, so
    the trainer refuses anything but the defaults."""

    num_devices: Optional[int] = None
    model_parallel: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# Reference experiment presets -------------------------------------------------

def preset_pandaset_weighted() -> ExperimentConfig:
    """train_pandaset.py:79-163: 3-class weighted run, 30 epochs, concat-256
    (the JAX package's config.py::preset_pandaset_weighted). Three classes
    over 2-class labels is the reference's own quirk, and the metrics stay
    2-class (TrainConfig.metrics_num_classes)."""
    return ExperimentConfig(
        model=ModelConfig(num_classes=3, fusion_type="concat",
                          fusion_out_channels=256),
        data=DataConfig(dataset="pandaset"),
        train=TrainConfig(num_epochs=30, class_weights=(0.39, 2.61, 33.09),
                          save_dir="checkpoints/pandaset_weighted"),
    )


def preset_fusion_ablation(fusion_type: str) -> ExperimentConfig:
    """train_with_fusion_ablation.py:10-66: 2-class, 20 epochs per variant
    (the JAX package's config.py::preset_fusion_ablation), on PandaSet unless
    --dataset says otherwise."""
    out_ch = {"concat": 256, "minimal": 128, "weighted": 128,
              "gated_sum": 128}[fusion_type]
    return ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type=fusion_type,
                          fusion_out_channels=out_ch),
        data=DataConfig(dataset="pandaset"),
        train=TrainConfig(num_epochs=20, class_weights=(0.4, 3.5),
                          save_dir=f"checkpoints/fusion_ablation_{fusion_type}"),
    )
