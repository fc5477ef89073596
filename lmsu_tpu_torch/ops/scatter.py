"""BEV cell indices and the plain BEV scatter-max variants.

Counterpart of lmsu_tpu/ops/scatter.py. The semantics to match (reference:
lidar_encoder.py:57-99, torch `scatter_reduce_(amax, include_self=False)`):

  * each valid point writes its feature vector into its (row, col) BEV cell,
    cells reduce with max over points;
  * cells receiving no point are exactly zero;
  * the zero initialisation does NOT enter the max, so all-negative
    features still land;
  * out-of-range points are dropped entirely.

The JAX package leaves these scatters to XLA; the port leaves them to plain
PyTorch: `bev_scatter_max` (scatter_impl="xla", autograd's backward),
`bev_scatter_max_fastbwd` ("xla_fastbwd") and `bev_scatter_max_sorted`
("sorted": sort, segmented prefix max, lookup), the last two with the shared
dense tie-splitting VJP `scatter_max_dense_bwd`. The kernels the port writes
by hand are the sorted-input scatter (ops/scatter_sorted.py) and the
unsorted one (ops/voxelize.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
    untouched cells are exactly 0. Points in any order.

    The buffer starts at -inf, as the JAX package's does, and untouched
    cells become 0 afterwards: the forward is the same as a zero buffer
    with include_self=False, and autograd's backward then splits a cell's
    gradient over its tied points only. (From a zero buffer it would count
    the buffer among the ties of a cell whose max is exactly 0, which ReLU
    features often give.)"""
    B, N, C = features.shape
    H, W = grid_size
    ncells = H * W
    offsets = torch.arange(B, device=features.device, dtype=torch.int64)[:, None] * ncells
    # Invalid points go to one junk row past the grid, sliced away below.
    idx = torch.where(valid, flat_idx.to(torch.int64) + offsets, B * ncells)
    out = features.new_full((B * ncells + 1, C), float("-inf"))
    out = out.scatter_reduce(0, idx.reshape(B * N, 1).expand(B * N, C),
                             features.reshape(B * N, C), "amax", include_self=False)
    out = torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype,
                                                       device=out.device), out)
    return out[:B * ncells].reshape(B, H, W, C)


def scatter_max_dense_bwd(features: torch.Tensor, flat_idx: torch.Tensor,
                          valid: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                          grid_size: Tuple[int, int]) -> torch.Tensor:
    """The shared dense VJP of scatter-max (lmsu_tpu/ops/scatter.py::
    _scatter_max_dense_bwd): a cell's cotangent goes to the valid points
    whose feature equals the cell's max, split evenly over them per channel.
    Tie counts are f32 sums of the 0/1 winners (exact below 2^24 points);
    the result g / max(count, 1) is f32, cast to the feature dtype."""
    B, N, C = features.shape
    H, W = grid_size
    ncells = H * W
    idx = flat_idx.clamp(0, ncells - 1).long().unsqueeze(-1).expand(B, N, C)
    cell_max = torch.gather(out.reshape(B, ncells, C), 1, idx)
    winner = (features == cell_max) & valid.unsqueeze(-1)
    offsets = torch.arange(B, device=features.device)[:, None] * ncells
    sidx = torch.where(valid, idx[..., 0] + offsets, B * ncells).reshape(B * N)
    counts = torch.zeros(B * ncells + 1, C, dtype=torch.float32, device=features.device)
    counts.index_add_(0, sidx, winner.reshape(B * N, C).to(torch.float32))
    gn = (g.reshape(B, ncells, C).to(torch.float32)
          / counts[:B * ncells].reshape(B, ncells, C).clamp(min=1.0))
    per_point = torch.gather(gn, 1, idx)
    return torch.where(winner, per_point, 0.0).to(features.dtype)


class _DenseVJPScatterMax(torch.autograd.Function):
    """A scatter-max forward [B,N,C] -> [B,H,W,C] with the dense VJP above."""

    @staticmethod
    def forward(ctx, forward: Callable, features, flat_idx, valid, grid_size):
        out = forward(features, flat_idx, valid, grid_size)
        ctx.save_for_backward(features, flat_idx, valid, out)
        ctx.grid_size = grid_size
        return out

    @staticmethod
    def backward(ctx, g):
        features, flat_idx, valid, out = ctx.saved_tensors
        d = scatter_max_dense_bwd(features, flat_idx, valid, out, g, ctx.grid_size)
        return None, d, None, None, None


def with_dense_vjp(forward: Callable, features: torch.Tensor, flat_idx: torch.Tensor,
                   valid: torch.Tensor, grid_size: Tuple[int, int]) -> torch.Tensor:
    """`forward(features, flat_idx, valid, grid_size)`, differentiable in
    `features` through `scatter_max_dense_bwd`."""
    return _DenseVJPScatterMax.apply(forward, features, flat_idx, valid, tuple(grid_size))


def bev_scatter_max_fastbwd(features: torch.Tensor, flat_idx: torch.Tensor,
                            valid: torch.Tensor, grid_size: Tuple[int, int]) -> torch.Tensor:
    """bev_scatter_max with the dense 3-pass backward instead of autograd's
    (scatter_impl="xla_fastbwd")."""
    return with_dense_vjp(bev_scatter_max, features, flat_idx, valid, grid_size)


def segmented_prefix_max(x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele segmented inclusive prefix max along dim 1 of x
    [B, L, C] over runs of equal sorted keys [B, L]: equal sorted keys k
    apart lie in one run, so after the log2(L) passes each point holds the
    max of its run up to itself, and a run's max lands at its last point."""
    L = x.shape[1]
    k = 1
    while k < L:
        same = (keys[:, k:] == keys[:, :-k]).unsqueeze(-1)
        x = torch.cat([x[:, :k], torch.where(same, torch.maximum(x[:, k:], x[:, :-k]),
                                             x[:, k:])], dim=1)
        k *= 2
    return x


def _sorted_forward(features, flat_idx, valid, grid_size):
    """Scatter-max without a scatter (lmsu_tpu/ops/scatter.py::
    _sorted_forward): a stable sort of the cell keys (invalid points get the
    sentinel H*W and sort last), the features gathered into that order, the
    segmented prefix max, then per cell searchsorted(side="right") - 1 and
    one gather; missed cells 0."""
    B, N, C = features.shape
    H, W = grid_size
    ncells = H * W
    idx = torch.where(valid, flat_idx, ncells).to(torch.int32)
    sidx, order = torch.sort(idx, dim=1, stable=True)
    x = segmented_prefix_max(torch.gather(features, 1, order.unsqueeze(-1).expand(B, N, C)),
                             sidx)
    cells = torch.arange(ncells, dtype=torch.int32, device=features.device)
    pos = torch.searchsorted(sidx.contiguous(), cells.expand(B, ncells).contiguous(),
                             right=True).to(torch.int32) - 1
    pos_c = pos.clamp(0, N - 1).long()
    hit = (pos >= 0) & (torch.gather(sidx, 1, pos_c) == cells)
    out = torch.gather(x, 1, pos_c.unsqueeze(-1).expand(B, ncells, C))
    out = torch.where(hit.unsqueeze(-1), out, torch.zeros((), dtype=features.dtype,
                                                          device=features.device))
    return out.reshape(B, H, W, C)


def bev_scatter_max_sorted(features: torch.Tensor, flat_idx: torch.Tensor,
                           valid: torch.Tensor, grid_size: Tuple[int, int]) -> torch.Tensor:
    """The sort-based scatter-max for points in ANY order (scatter_impl=
    "sorted"), with the dense VJP. Not to be confused with the kernel for
    pre-sorted points, ops/scatter_sorted.py::bev_scatter_max_sorted_pallas."""
    return with_dense_vjp(_sorted_forward, features, flat_idx, valid, grid_size)


def bev_voxelize_max(points: torch.Tensor, features: torch.Tensor,
                     grid_size: Tuple[int, int],
                     pc_range: Tuple[float, float, float, float, float, float],
                     point_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B,N,>=2] + per-point features [B,N,C] -> [B,H,W,C] BEV map."""
    flat_idx, valid = points_to_bev_indices(points[..., :2], grid_size, pc_range)
    if point_valid is not None:
        valid = valid & point_valid
    return bev_scatter_max(features, flat_idx, valid, grid_size)
