"""Spatial LiDAR BEV encoder.

Counterpart of lmsu_tpu/models/lidar_encoder.py (reference:
lidar_encoder.py:9-154): a shared per-point MLP (Conv1d k=1 + BN + ReLU,
under the reference's `point_mlp.{0..8}` names) followed by max-pooling of
point features into a BEV grid.

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


class SpatialLiDAREncoder(nn.Module):
    """Per-point MLP + BEV scatter-max. Reference: lidar_encoder.py:9."""

    def __init__(self, config: LidarEncoderConfig = LidarEncoderConfig()):
        super().__init__()
        self.config = config
        layers: List[nn.Module] = []
        cin = config.input_dim
        for d in tuple(config.mlp_dims) + (config.feature_dim,):
            layers += [nn.Conv1d(cin, d, 1, bias=True),
                       BatchNorm1d(d, eps=1e-5, momentum=0.1), nn.ReLU()]
            cin = d
        self.point_mlp = nn.Sequential(*layers)

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


class LiDAREncoder(nn.Module):
    """Facade selecting the encoder (reference: lidar_encoder.py:193-221).
    The port has the "spatial" encoder; "pointpillars" is not ported yet."""

    def __init__(self, config: LidarEncoderConfig = LidarEncoderConfig()):
        super().__init__()
        if config.encoder_type != "spatial":
            raise NotImplementedError(
                f"encoder_type {config.encoder_type!r} is not ported yet")
        self.config = config
        self.encoder = SpatialLiDAREncoder(config)

    def forward(self, points: torch.Tensor, point_valid: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.encoder(points, point_valid, dtype)
