"""Camera FPN, weighted fusion, same-resolution head and the complete model.

Counterpart of lmsu_tpu/models/fusion.py (reference: fusion_module.py):
  CameraFPNLite                  fusion_module.py:37-64
  WeightedFusion                 fusion_module.py:107-136
  SameResolutionSegmentationHead fusion_module.py:162-173
  CompleteSegmentationModel      fusion_module.py:179-286

Public layout is the JAX package's: NHWC images [B, H, W, 3] (uint8 or
float) and points [B, N, 4] in, NHWC logits [B, h, w, num_classes] out.
Inside, features are NCHW tensors in channels-last memory (the NHWC input
viewed as NCHW), so the kernels that want channel-contiguous rows (the
fused InvertedResidual and the fusion gate) get them without a copy.

Not ported yet: the concat, minimal and gated_sum fusions and the x4 head
(models/factory.py rejects them).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.models.camera_encoder import TwinLiteEncoder
from lmsu_tpu_torch.models.layers import Conv1x1Block, DWSeparableConv, apply_seq
from lmsu_tpu_torch.models.lidar_encoder import LiDAREncoder
from lmsu_tpu_torch.ops.fusion_gate import fusion_gate
from lmsu_tpu_torch.ops.resize import resize_bilinear


class CameraFPNLite(nn.Module):
    """Sum of per-stage 1x1 laterals resized to the largest stage, then a
    depthwise-separable smoothing conv. Reference: fusion_module.py:37-64."""

    def __init__(self, in_channels: Dict[str, int], target_channels: int = 128,
                 stages_to_use: Optional[Sequence[str]] = None):
        super().__init__()
        self.stages = tuple(stages_to_use or in_channels.keys())
        self.laterals = nn.ModuleDict(
            {s: Conv1x1Block(in_channels[s], target_channels) for s in self.stages})
        self.post = DWSeparableConv(target_channels, target_channels)

    def forward(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        hw = max((tuple(feats[s].shape[-2:]) for s in self.stages),
                 key=lambda x: x[0] * x[1])
        fused = None
        for s in self.stages:
            x = resize_bilinear(self.laterals[s](feats[s]), hw)
            fused = x if fused is None else fused + x
        return self.post(fused)


class WeightedFusion(nn.Module):
    """Per-pixel learned 2-way softmax gate over the two modalities
    (reference: fusion_module.py:107-136). use_fused_gate runs the gate as
    one CUDA kernel (ops/fusion_gate.py)."""

    def __init__(self, cam_in: int, lidar_in: int, out_channels: int = 128,
                 use_fused_gate: bool = False):
        super().__init__()
        self.use_fused_gate = use_fused_gate
        self.cam_proj = Conv1x1Block(cam_in, out_channels)
        self.lidar_proj = Conv1x1Block(lidar_in, out_channels)
        self.attention = nn.Sequential(
            nn.Conv2d(2 * out_channels, out_channels, 1, bias=True), nn.ReLU(),
            nn.Conv2d(out_channels, 2, 1, bias=True), nn.Softmax(dim=1))

    def forward(self, cam_feat: torch.Tensor, lidar_feat: torch.Tensor):
        cam = self.cam_proj(cam_feat)
        lid = self.lidar_proj(lidar_feat)
        if self.use_fused_gate:
            a0, a2 = self.attention[0], self.attention[2]
            out = fusion_gate(cam.permute(0, 2, 3, 1), lid.permute(0, 2, 3, 1),
                              a0.weight, a0.bias, a2.weight, a2.bias)
            fused = out.permute(0, 3, 1, 2)
        else:
            w = apply_seq(self.attention, torch.cat([cam, lid], dim=1))
            fused = cam * w[:, 0:1] + lid * w[:, 1:2]
        return fused, fused


class SameResolutionSegmentationHead(nn.Module):
    """DWSep(in->64) -> DWSep(64->32) -> 1x1 classifier (reference:
    fusion_module.py:162-173)."""

    def __init__(self, in_channels: int, num_classes: int = 2):
        super().__init__()
        self.block = nn.ModuleList([DWSeparableConv(in_channels, 64),
                                    DWSeparableConv(64, 32)])
        self.cls = nn.Conv2d(32, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b in self.block:
            x = b(x)
        return apply_seq([self.cls], x)


class CompleteSegmentationModel(nn.Module):
    """Camera encoder (+FPN) + LiDAR encoder + weighted fusion + head.

    forward(images [B,H,W,3], points [B,N,4], point_valid=None) -> logits
    [B, h, w, num_classes]; with return_intermediates=True also the KD tap
    dict {camera_feat, lidar_feat, pre_fusion, post_fusion, logits} (taps
    NCHW)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.camera_encoder = TwinLiteEncoder(config.camera)
        if config.camera.return_multiscale:
            self.camera_fpn = CameraFPNLite(self.camera_encoder.feature_channels,
                                            config.camera_fpn_channels,
                                            config.camera_fpn_stages)
            cam_ch = config.camera_fpn_channels
        else:
            self.camera_fpn = None
            cam_ch = self.camera_encoder.out_channels
        self.lidar_encoder = LiDAREncoder(config.lidar)
        # Non-concat fusions output at the camera-feature width (reference:
        # fusion_module.py:206-222).
        self.fusion = WeightedFusion(cam_ch, config.lidar.feature_dim, cam_ch,
                                     use_fused_gate=config.use_pallas_fusion)
        self.head = SameResolutionSegmentationHead(cam_ch, config.num_classes)

    def forward(self, images: torch.Tensor, points: torch.Tensor,
                point_valid: Optional[torch.Tensor] = None,
                return_intermediates: bool = False):
        dt = self.config.compute_dtype
        # uint8 images are normalised on the device, in the compute dtype
        # (4x cheaper host->device transfer than f32).
        if images.dtype == torch.uint8:
            images = images.to(dt) / 255.0
        x = images.to(dt).permute(0, 3, 1, 2)
        cam_raw = self.camera_encoder(x)
        cam_feat = self.camera_fpn(cam_raw) if self.camera_fpn is not None else cam_raw
        lidar_feat = self.lidar_encoder(points, point_valid, dt).permute(0, 3, 1, 2)
        if cam_feat.shape[-2:] != lidar_feat.shape[-2:]:
            lidar_feat = resize_bilinear(lidar_feat, tuple(cam_feat.shape[-2:]))
        pre_fusion, fused = self.fusion(cam_feat, lidar_feat)
        logits = self.head(fused).permute(0, 2, 3, 1).contiguous()
        if return_intermediates:
            return logits, {"camera_feat": cam_feat, "lidar_feat": lidar_feat,
                            "pre_fusion": pre_fusion, "post_fusion": fused,
                            "logits": logits}
        return logits
