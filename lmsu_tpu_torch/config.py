"""Configuration of the PyTorch port: the same dataclasses, fields and
defaults as the JAX package's config, with `compute_dtype` a `torch.dtype`.

Defaults of record (reference file:line):
  image 256x256                         pandaset_dataset.py:56
  BEV grid 64x64, pc_range +-50 m       pandaset_dataset.py:57,66
  max_points 5000                       pandaset_dataset.py:58
  lidar pc range [-50,-50,-5,50,50,3]   lidar_encoder.py:12

This slice of the port serves the weighted-fusion model with the
same-resolution head. Fields that select paths the port does not have yet
(other fusions, the x4 head, the pillar encoder, training-only kernels)
are kept so configurations stay interchangeable, and `models.factory`
rejects them by name.
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
    # Training-only fused kernels; not ported yet.
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
