"""Configuration of the PyTorch port: the same dataclasses, fields and
defaults as the JAX package's config, with `compute_dtype` a `torch.dtype`.

Defaults of record (reference file:line):
  image 256x256                         pandaset_dataset.py:56
  BEV grid 64x64, pc_range +-50 m       pandaset_dataset.py:57,66
  max_points 5000                       pandaset_dataset.py:58
  lidar pc range [-50,-50,-5,50,50,3]   lidar_encoder.py:12

The port serves and trains (KD) the weighted-fusion model with the
same-resolution head. Fields that select paths the port does not have yet
(other fusions, the x4 head, the pillar encoder, the fused training
blocks, augmentation, the teacher cache, parallelism, on-device epochs)
are kept so configurations stay interchangeable; `models.factory` and the
trainers reject them by name.

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
    # Training-only (stage rematerialisation); not ported yet.
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
    # BEV scatter-max algorithm: "xla" (the plain unsorted scatter,
    # ops/scatter.py) or "sorted_pallas" (the sorted-input segment-max
    # kernel, ops/scatter_sorted.py; REQUIRES points pre-sorted by BEV cell,
    # which the Predictor and the serving engine do on the host through
    # data/rasterize.py::make_point_sorter). The name is the JAX package's,
    # so one configuration selects the same path in both packages.
    scatter_impl: str = "xla"
    # Deprecated alias of scatter_impl="pallas" in the JAX package; that
    # kernel is not ported yet.
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
    """Dataset + host input pipeline (reference: pandaset_dataset.py:48-157).
    The port has the synthetic dataset; "pandaset" and "packed" are refused
    by `data.create_datasets`."""

    dataset: str = "synthetic"
    image_size: Tuple[int, int] = (256, 256)
    grid_size: Tuple[int, int] = (64, 64)
    max_points: int = 5000
    pc_range: Tuple[float, float, float, float] = (-50.0, 50.0, -50.0, 50.0)
    batch_size: int = 4
    shuffle_train: bool = True
    num_workers: int = 2
    synthetic_num_train: int = 800
    synthetic_num_val: int = 200
    synthetic_difficulty: str = "easy"


@dataclass(frozen=True)
class AugmentConfig:
    """Device-side training augmentation; not ported yet, so the trainer
    refuses `enabled=True`. The JAX package's per-transform fields come
    with the port of ops/augment.py."""

    enabled: bool = False


@dataclass(frozen=True)
class KDConfig:
    """Teacher->student distillation loss (JAX package: config.py KDConfig).

    The port trains with one in-loop teacher. Ensembles
    (`teacher_checkpoints`, `ensemble_size > 1`), the dataset-wide teacher
    cache (`cache_teacher`) and teacher partitioning other than the
    single-device default are refused by `training.DistillationTrainer`.
    `use_pallas` routes the feature-matching loss through the hand-written
    kernel (ops/kd_loss.py); the name is the JAX package's."""

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
    teacher_partition: str = "tp"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop (reference: trainer.py:40-74). Options the port
    does not have yet (scan_steps > 1, onchip_epoch, onchip_eval=True,
    augmentation, SIGTERM handling, async and snapshot checkpoints,
    debug_nans, progress bars) are refused by `training.Trainer`."""

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
