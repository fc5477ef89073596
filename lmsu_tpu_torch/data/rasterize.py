"""Host sort key and point sorter for the sorted-input scatter (numpy).

Counterpart of lmsu_tpu/data/rasterize.py::bev_cell_key / make_point_sorter.
The JAX package routes the sort through a native counting sort when it is
built; its numpy stable-argsort fallback is bit-identical to it, and that
fallback is what the port uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bev_cell_key(points: np.ndarray, grid_size: Tuple[int, int],
                 pc_range6, point_valid: np.ndarray | None = None
                 ) -> np.ndarray:
    """Host replica of ops/scatter.py::points_to_bev_indices as a sort key:
    flat cell id for in-range valid points, H*W (sentinel) otherwise. f32
    arithmetic in the same op order as the device computation."""
    H, W = grid_size
    x_min, y_min, x_max, y_max = (np.float32(pc_range6[0]),
                                  np.float32(pc_range6[1]),
                                  np.float32(pc_range6[3]),
                                  np.float32(pc_range6[4]))
    x = points[..., 0].astype(np.float32)
    y = points[..., 1].astype(np.float32)
    x_norm = (x - x_min) / (x_max - x_min)
    y_norm = (y - y_min) / (y_max - y_min)
    valid = (x_norm >= 0) & (x_norm <= 1) & (y_norm >= 0) & (y_norm <= 1)
    if point_valid is not None:
        valid &= point_valid
    col = np.clip((x_norm * (W - 1)).astype(np.int32), 0, W - 1)
    row = np.clip((y_norm * (H - 1)).astype(np.int32), 0, H - 1)
    return np.where(valid, row * W + col, H * W).astype(np.int32)


def make_point_sorter(grid_size: Tuple[int, int], pc_range6):
    """Per-sample transform reordering `points` (and `point_valid`) by BEV
    cell id, invalid/out-of-range last: the input contract of the sorted
    scatter kernel (ops/scatter_sorted.py). The model is order-invariant
    (per-point MLP + max pooling), so the transform preserves semantics."""

    def transform(sample):
        pts = sample["points"]
        pv = sample.get("point_valid")
        out = dict(sample)
        order = np.argsort(bev_cell_key(pts, grid_size, pc_range6, pv), kind="stable")
        out["points"] = pts[order]
        if pv is not None:
            out["point_valid"] = pv[order]
        return out

    return transform
