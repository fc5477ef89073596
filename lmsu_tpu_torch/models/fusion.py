"""Camera FPN, the four fusions, both heads and the complete model.

Counterpart of lmsu_tpu/models/fusion.py (reference: fusion_module.py):
  CameraFPNLite                  fusion_module.py:37-64
  ConcatenationFusion            fusion_module.py:70-91
  MinimalFusion                  fusion_module.py:94-104
  WeightedFusion                 fusion_module.py:107-136
  GatedSumFusion                 no reference analog (the JAX package's own)
  LightweightSegmentationHead    fusion_module.py:142-159   (x4 upsample)
  SameResolutionSegmentationHead fusion_module.py:162-173
  CompleteSegmentationModel      fusion_module.py:179-286

Torch names are the reference's (lmsu_tpu/utils/torch_compat.py:147-174):
concat's projections are `fusion.camera_proj` / `fusion.lidar_proj` and its
depthwise + pointwise convs `fusion.fuse.{0,1,3,4}`; the other fusions'
projections are `fusion.cam_proj` / `fusion.lidar_proj`; the x4 head is
`head.up{1,2}.{0,1}` (transposed conv, BatchNorm) and `head.cls`. The gated
sum has no reference, so no reference names: its gate net is named as the
weighted fusion's (`fusion.attention.{0,2}`, a Sigmoid at index 3).

Public layout is the JAX package's: NHWC images [B, H, W, 3] (uint8 or
float) and points [B, N, 4] in, NHWC logits [B, h, w, num_classes] out.
Inside, features are NCHW tensors in channels-last memory (the NHWC input
viewed as NCHW), so the kernels that want channel-contiguous rows (the
fused InvertedResidual and the fusion gate) get them without a copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.models.camera_encoder import TwinLiteEncoder
from lmsu_tpu_torch.models.layers import (BatchNorm2d, Conv1x1Block, DWSeparableConv,
                                          apply_seq, conv_bn_act)
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


class ConcatenationFusion(nn.Module):
    """1x1 per-modality projection at each input's own width, concat, then
    a depthwise 3x3 and a pointwise 1x1 to out_channels, each with BN and
    ReLU (reference: fusion_module.py:70-91). Returns (pre_fusion, fused)."""

    def __init__(self, cam_in: int, lidar_in: int, out_channels: int = 256):
        super().__init__()
        cat = cam_in + lidar_in
        self.camera_proj = Conv1x1Block(cam_in, cam_in)
        self.lidar_proj = Conv1x1Block(lidar_in, lidar_in)
        self.fuse = nn.Sequential(*conv_bn_act(cat, cat, 3, groups=cat, act=nn.ReLU()),
                                  *conv_bn_act(cat, out_channels, 1, act=nn.ReLU()))

    def forward(self, cam_feat: torch.Tensor, lidar_feat: torch.Tensor):
        pre = torch.cat([self.camera_proj(cam_feat), self.lidar_proj(lidar_feat)], dim=1)
        return pre, apply_seq(self.fuse, pre)


class MinimalFusion(nn.Module):
    """Elementwise add of the 1x1-projected modalities (reference:
    fusion_module.py:94-104)."""

    def __init__(self, cam_in: int, lidar_in: int, out_channels: int = 128):
        super().__init__()
        self.cam_proj = Conv1x1Block(cam_in, out_channels)
        self.lidar_proj = Conv1x1Block(lidar_in, out_channels)

    def forward(self, cam_feat: torch.Tensor, lidar_feat: torch.Tensor):
        fused = self.cam_proj(cam_feat) + self.lidar_proj(lidar_feat)
        return fused, fused


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


class GatedSumFusion(WeightedFusion):
    """Independent per-pixel sigmoid gates, fused = cam g0 + lid g1: the
    weighted fusion's gate net with a sigmoid in place of the softmax (the
    JAX package's GatedSumFusion, models/fusion.py:189-233; no reference
    analog, so no reference names: the gate is `attention.{0,2}` as in the
    weighted fusion, with the Sigmoid at index 3). Plain PyTorch: the fused
    gate kernel computes a softmax."""

    def __init__(self, cam_in: int, lidar_in: int, out_channels: int = 128):
        super().__init__(cam_in, lidar_in, out_channels)
        self.attention[3] = nn.Sigmoid()


def _upsample2x(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose2d(k4, s2, p1) + BatchNorm + ReLU: x2 in each spatial dim."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=False),
                         BatchNorm2d(cout, eps=1e-5, momentum=0.1), nn.ReLU())


class LightweightSegmentationHead(nn.Module):
    """Two transposed-conv x2 upsamples to 64 and 16 channels, then a 3x3
    classifier with bias: logits at 4x the fused map's size (reference:
    fusion_module.py:142-159)."""

    def __init__(self, in_channels: int, num_classes: int = 2):
        super().__init__()
        self.up1 = _upsample2x(in_channels, 64)
        self.up2 = _upsample2x(64, 16)
        self.cls = nn.Conv2d(16, num_classes, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_seq([self.cls], apply_seq(self.up2, apply_seq(self.up1, x)))


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
    """Camera encoder (+FPN) + LiDAR encoder + fusion + head.

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
        # Concat outputs fusion_out_channels; the other fusions output at the
        # camera-feature width (reference: fusion_module.py:206-222). The
        # fused gate kernel is the weighted fusion's only.
        lid_ch, ft = config.lidar.feature_dim, config.fusion_type
        if ft == "concat":
            self.fusion = ConcatenationFusion(cam_ch, lid_ch, config.fusion_out_channels)
            fused_ch = config.fusion_out_channels
        elif ft in ("minimal", "weighted", "gated_sum"):
            kw = {"use_fused_gate": config.use_pallas_fusion} if ft == "weighted" else {}
            self.fusion = {"minimal": MinimalFusion, "weighted": WeightedFusion,
                           "gated_sum": GatedSumFusion}[ft](cam_ch, lid_ch, cam_ch, **kw)
            fused_ch = cam_ch
        else:
            raise ValueError(f"Unknown fusion_type: {ft}")
        if config.output_mode == "x4":
            self.head = LightweightSegmentationHead(fused_ch, config.num_classes)
        elif config.output_mode == "same":
            self.head = SameResolutionSegmentationHead(fused_ch, config.num_classes)
        else:
            raise ValueError(f"Unknown output_mode: {config.output_mode}")

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
