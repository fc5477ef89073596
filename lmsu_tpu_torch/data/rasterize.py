"""Label remapping, BEV label rasterization and the host cell sort (numpy).

The port's copy of lmsu_tpu/data/rasterize.py, with the reference's
semantics (pandaset_dataset.py:13-45), vectorized:

  * remap_semantic: PandaSet raw ids {6, 7, 8, 9, 10, 12} -> 1 (drivable),
    else 0.
  * rasterize_bev: a cell takes a label only while it still holds 0, so the
    first NONZERO label in point order wins (for {0, 1} labels: a cell is 1
    iff a point labelled 1 lands in it). NaN coordinates fail the range test
    and are dropped.
  * bev_cell_key / make_point_sorter: points ordered by BEV cell, invalid
    and out-of-range last, the sorted scatter's input contract. The sort
    takes the native counting sort (data/native.py) when the library loads;
    the numpy stable argsort is bit-identical to it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Ground, Road, Lane markings, Stop lines, Other markings, Driveway
# (reference: pandaset_dataset.py:13).
DRIVABLE_RAW_IDS = (6, 7, 8, 9, 10, 12)


def remap_semantic(raw_ids: np.ndarray) -> np.ndarray:
    """PandaSet raw class ids -> {0 = background, 1 = drivable}."""
    return np.isin(raw_ids, DRIVABLE_RAW_IDS).astype(np.int64)


def rasterize_bev(
    x: np.ndarray, y: np.ndarray, labels: np.ndarray,
    grid_size: Tuple[int, int] = (64, 64),
    pc_range: Tuple[float, float, float, float] = (-50, 50, -50, 50),
) -> np.ndarray:
    """Per-point labels -> an [H, W] int64 label grid, first nonzero wins."""
    H, W = grid_size
    x_min, x_max, y_min, y_max = pc_range
    mask = np.zeros((H, W), dtype=np.int64)
    m = (x >= x_min) & (x <= x_max) & (y >= y_min) & (y <= y_max)
    x, y, labels = x[m], y[m], labels[m]
    if x.size == 0:
        return mask
    col = np.clip(((x - x_min) / (x_max - x_min) * (W - 1)).astype(int), 0, W - 1)
    row = np.clip(((y - y_min) / (y_max - y_min) * (H - 1)).astype(int), 0, H - 1)
    flat = row * W + col
    # Among nonzero-labelled points, np.unique(return_index) gives each
    # cell's first in point order.
    nz = labels != 0
    if nz.any():
        cells, first = np.unique(flat[nz], return_index=True)
        mask.ravel()[cells] = labels[nz][first]
    return mask


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
    (per-point MLP + max pooling), so the transform preserves semantics.
    It returns new arrays and never writes into the sample's own."""
    range4 = (pc_range6[0], pc_range6[3], pc_range6[1], pc_range6[4])

    def transform(sample):
        from lmsu_tpu_torch.data.native import sort_points_by_cell_native
        pts = sample["points"]
        pv = sample.get("point_valid")
        out = dict(sample)
        native = sort_points_by_cell_native(pts, grid_size, range4, pv)
        if native is not None:
            out["points"], valid_sorted = native
            if pv is not None:
                out["point_valid"] = valid_sorted
            return out
        order = np.argsort(bev_cell_key(pts, grid_size, pc_range6, pv), kind="stable")
        out["points"] = pts[order]
        if pv is not None:
            out["point_valid"] = pv[order]
        return out

    return transform
