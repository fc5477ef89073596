"""BEV cell indices and the plain (unsorted) BEV scatter-max.

Counterpart of lmsu_tpu/ops/scatter.py. The semantics to match (reference:
lidar_encoder.py:57-99, torch `scatter_reduce_(amax, include_self=False)`):

  * each valid point writes its feature vector into its (row, col) BEV cell,
    cells reduce with max over points;
  * cells receiving no point are exactly zero;
  * the zero initialisation does NOT enter the max, so all-negative
    features still land;
  * out-of-range points are dropped entirely.

The JAX package leaves this scatter to XLA; the port leaves it to PyTorch's
`scatter_reduce_`. The kernel the port writes by hand is the sorted-input
scatter (ops/scatter_sorted.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def points_to_bev_indices(
    points_xy: torch.Tensor,
    grid_size: Tuple[int, int],
    pc_range: Tuple[float, float, float, float, float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map point x/y to flat BEV cell indices.

    Normalise x, y to [0, 1] over the range, scale by (W-1)/(H-1), truncate
    toward zero, clamp into the grid; a point is valid iff its normalised
    coordinates lie in the closed range [0, 1].

    The arithmetic is f32 in the op order of the host sort key
    (data/rasterize.py::bev_cell_key), so the device index equals the key
    the host sorted by. The range width is divided as a tensor, not as a
    Python scalar: PyTorch's CUDA division by a CPU scalar multiplies by the
    reciprocal, which rounds differently from numpy's true division and
    would move points that sit on a cell boundary.

    Args:
      points_xy: [..., N, 2] x/y coordinates (float32).
      grid_size: (H, W).
      pc_range: (x_min, y_min, z_min, x_max, y_max, z_max).

    Returns:
      (flat_idx [..., N] int32 in [0, H*W), valid [..., N] bool)
    """
    H, W = grid_size
    x_min, y_min, _, x_max, y_max, _ = (float(np.float32(v)) for v in pc_range)
    x = points_xy[..., 0]
    y = points_xy[..., 1]
    x_norm = (x - x_min) / torch.full_like(x, float(np.float32(x_max) - np.float32(x_min)))
    y_norm = (y - y_min) / torch.full_like(y, float(np.float32(y_max) - np.float32(y_min)))
    valid = (x_norm >= 0) & (x_norm <= 1) & (y_norm >= 0) & (y_norm <= 1)
    col = torch.clamp((x_norm * (W - 1)).to(torch.int32), 0, W - 1)
    row = torch.clamp((y_norm * (H - 1)).to(torch.int32), 0, H - 1)
    return row * W + col, valid


def bev_scatter_max(
    features: torch.Tensor,
    flat_idx: torch.Tensor,
    valid: torch.Tensor,
    grid_size: Tuple[int, int],
) -> torch.Tensor:
    """Max-scatter per-point features [B, N, C] into a BEV grid [B, H, W, C];
    untouched cells are exactly 0. Points in any order."""
    B, N, C = features.shape
    H, W = grid_size
    ncells = H * W
    offsets = torch.arange(B, device=features.device, dtype=torch.int64)[:, None] * ncells
    # Invalid points go to one junk row past the grid, sliced away below.
    idx = torch.where(valid, flat_idx.to(torch.int64) + offsets, B * ncells)
    out = features.new_zeros(B * ncells + 1, C)
    out.scatter_reduce_(0, idx.reshape(B * N, 1).expand(B * N, C),
                        features.reshape(B * N, C), "amax", include_self=False)
    return out[:B * ncells].reshape(B, H, W, C)
