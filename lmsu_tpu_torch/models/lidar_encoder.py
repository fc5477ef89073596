"""LiDAR BEV encoders: the spatial (PointNet-style) one and PointPillars.

Counterpart of lmsu_tpu/models/lidar_encoder.py (reference:
lidar_encoder.py:9-154): a shared per-point MLP (Conv1d k=1 + BN + ReLU,
under the reference's `point_mlp.{0..8}` names) followed by max-pooling of
point features into a BEV grid. The pillar-feature net (the JAX package's
PointPillarsLiDAREncoder, :93-150) decorates each point with its offsets
to its cell's centre and its planar distance first, and names its layers
`pfn.{0..8}` in the same layout.

Reference parity quirk kept on purpose: the MLP runs over *all* points
(padded ones included) and validity only gates the scatter. Zero-padded
points are in range (grid centre) and therefore valid unless the caller
passes `point_valid`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import LidarEncoderConfig
from lmsu_tpu_torch.models.layers import BatchNorm1d, apply_seq
from lmsu_tpu_torch.ops.scatter import (bev_scatter_max, bev_scatter_max_fastbwd,
                                        bev_scatter_max_sorted, points_to_bev_indices)
from lmsu_tpu_torch.ops.scatter_sorted import bev_scatter_max_sorted_pallas
from lmsu_tpu_torch.ops.voxelize import bev_scatter_max_pallas


def _scatter(cfg: LidarEncoderConfig, feats, flat_idx, valid):
    """Route to the configured scatter-max algorithm (equivalent outputs),
    in the JAX package's order (lmsu_tpu/models/lidar_encoder.py:37-57);
    the deprecated `use_pallas` selects "pallas"."""
    impl = "pallas" if cfg.use_pallas else cfg.scatter_impl
    if impl == "pallas":
        return bev_scatter_max_pallas(feats, flat_idx, valid, cfg.grid_size)
    if impl == "sorted":
        return bev_scatter_max_sorted(feats, flat_idx, valid, cfg.grid_size)
    if impl == "sorted_pallas":
        # Requires points pre-sorted by BEV cell (data/rasterize.py or
        # ops/scatter_sorted.py::sort_points_by_bev_cell).
        return bev_scatter_max_sorted_pallas(feats, flat_idx, valid, cfg.grid_size)
    if impl == "xla_fastbwd":
        return bev_scatter_max_fastbwd(feats, flat_idx, valid, cfg.grid_size)
    if impl == "xla":
        return bev_scatter_max(feats, flat_idx, valid, cfg.grid_size)
    raise ValueError(f"Unknown scatter_impl: {cfg.scatter_impl}")


def _mlp(cin: int, config: LidarEncoderConfig) -> nn.Sequential:
    """Conv1d(k=1) + BatchNorm1d + ReLU per width of mlp_dims + feature_dim."""
    layers: List[nn.Module] = []
    for d in tuple(config.mlp_dims) + (config.feature_dim,):
        layers += [nn.Conv1d(cin, d, 1, bias=True),
                   BatchNorm1d(d, eps=1e-5, momentum=0.1), nn.ReLU()]
        cin = d
    return nn.Sequential(*layers)


class SpatialLiDAREncoder(nn.Module):
    """Per-point MLP + BEV scatter-max. Reference: lidar_encoder.py:9."""

    def __init__(self, config: LidarEncoderConfig = LidarEncoderConfig()):
        super().__init__()
        self.config = config
        self.point_mlp = _mlp(config.input_dim, config)

    def forward(self, points: torch.Tensor, point_valid: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """points [B, N, input_dim] -> BEV features [B, H, W, feature_dim] (NHWC)."""
        cfg = self.config
        x = apply_seq(self.point_mlp, points.to(dtype).transpose(1, 2))
        feats = x.transpose(1, 2).contiguous()
        flat_idx, valid = points_to_bev_indices(points[..., :2], cfg.grid_size,
                                                cfg.point_cloud_range)
        if point_valid is not None:
            valid = valid & point_valid
        return _scatter(cfg, feats, flat_idx, valid)


class PointPillarsLiDAREncoder(nn.Module):
    """Pillar-feature net + BEV scatter-max (the JAX package's
    PointPillarsLiDAREncoder, lidar_encoder.py:93-150).

    Each point is decorated with (x - cx, y - cy) to the centre of its BEV
    cell and its planar distance, so the first PFN layer takes input_dim + 3
    channels. The centre uses points_to_bev_indices's own mapping, col =
    trunc(x_norm (W - 1)), so it is x_min + (col + 0.5) (x_max - x_min) /
    (W - 1). The decoration is computed in the compute dtype op by op as the
    JAX package computes it (every operand, the range's scalars included,
    in that dtype: in bf16 each op rounds to bf16), except the distance,
    which is taken in the points' float32 and cast after. As in the spatial
    encoder the MLP runs over every point, padded ones included, and
    validity only gates the scatter."""

    def __init__(self, config: LidarEncoderConfig = LidarEncoderConfig()):
        super().__init__()
        self.config = config
        self.pfn = _mlp(config.input_dim + 3, config)

    def forward(self, points: torch.Tensor, point_valid: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        cfg = self.config
        H, W = cfg.grid_size
        x_min, y_min, _, x_max, y_max, _ = cfg.point_cloud_range
        flat_idx, valid = points_to_bev_indices(points[..., :2], cfg.grid_size,
                                                cfg.point_cloud_range)
        if point_valid is not None:
            valid = valid & point_valid

        def s(v):  # a scalar operand in the compute dtype, as JAX's weak types
            return torch.tensor(v, dtype=dtype, device=points.device)
        col = (flat_idx % W).to(dtype)
        row = (flat_idx // W).to(dtype)
        cx = s(x_min) + (col + s(0.5)) * s(x_max - x_min) / s(W - 1)
        cy = s(y_min) + (row + s(0.5)) * s(y_max - y_min) / s(H - 1)
        dx = points[..., 0].to(dtype) - cx
        dy = points[..., 1].to(dtype) - cy
        dist = torch.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2 + 1e-8)
        feats = torch.cat([points.to(dtype), dx[..., None], dy[..., None],
                           dist[..., None].to(dtype)], dim=-1)
        x = apply_seq(self.pfn, feats.transpose(1, 2))
        return _scatter(cfg, x.transpose(1, 2).contiguous(), flat_idx, valid)


ENCODERS = {"spatial": SpatialLiDAREncoder, "pointpillars": PointPillarsLiDAREncoder}


class LiDAREncoder(nn.Module):
    """Facade selecting the encoder by LidarEncoderConfig.encoder_type
    (reference: lidar_encoder.py:193-221): "spatial" or "pointpillars"; any
    other type is a ValueError, as in the JAX package."""

    def __init__(self, config: LidarEncoderConfig = LidarEncoderConfig()):
        super().__init__()
        if config.encoder_type not in ENCODERS:
            raise ValueError(f"Unknown encoder type: {config.encoder_type}")
        self.config = config
        self.encoder = ENCODERS[config.encoder_type](config)

    def forward(self, points: torch.Tensor, point_valid: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.encoder(points, point_valid, dtype)
