"""BEV scatter-max over CELL-SORTED points: the hand-written CUDA kernel
(csrc/scatter_sorted_fwd.cu) and its plain PyTorch version.

Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel
(forward of bev_scatter_max_sorted_pallas). On the H100 it is bound by bytes:
each feature row is read once and each cell row written once (see the
source note in the .cu file). With the points sorted by cell, each cell
owns one contiguous span of points, so the kernel is a segmented reduction
with no atomics: deterministic and bit-exact against any other max.

Input contract: `where(valid, flat_idx, H*W)` is non-decreasing along the
point axis of every batch row (invalid points last). The Predictor and the
serving engine sort on the host (data/rasterize.py::make_point_sorter);
`sort_points_by_bev_cell` below sorts on the device. Unsorted input gives
wrong results silently, as on the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args,
                                      dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.scatter import points_to_bev_indices

KERNEL = CudaKernel("scatter_sorted_fwd.cu", {
    "scatter_sorted_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P)})


def cell_keys(flat_idx: torch.Tensor, valid: torch.Tensor, hw: int) -> torch.Tensor:
    """Per-point sort key [B, N] int32: the cell id, or hw for invalid points."""
    return torch.where(valid, flat_idx, hw).to(torch.int32).contiguous()


def segment_max_plain(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain version of the kernel: feats [B, N, C], sorted keys [B, N] ->
    [B, hw, C]. Same algorithm: each cell's span from a binary search of the
    sorted keys, then the max over the span (a segmented prefix max read at
    the span's last point); empty spans are 0."""
    B, N, C = feats.shape
    cells = torch.arange(hw + 1, device=feats.device, dtype=keys.dtype)
    bounds = torch.searchsorted(keys, cells.expand(B, hw + 1).contiguous(), side="left")
    lo, hi = bounds[:, :-1], bounds[:, 1:]
    x = feats
    k = 1
    while k < N:  # Hillis-Steele: equal sorted keys k apart share a segment
        same = (keys[:, k:] == keys[:, :-k]).unsqueeze(-1)
        x = torch.cat([x[:, :k], torch.where(same, torch.maximum(x[:, k:], x[:, :-k]),
                                             x[:, k:])], dim=1)
        k *= 2
    last = (hi - 1).clamp(min=0).to(torch.int64)
    out = torch.gather(x, 1, last.unsqueeze(-1).expand(B, hw, C))
    return torch.where((hi > lo).unsqueeze(-1), out, torch.zeros((), dtype=feats.dtype,
                                                                   device=feats.device))


def segment_max(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment max: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. feats [B, N, C] f32/bf16, keys [B, N] int32."""
    if feats.device.type == "cpu":
        return segment_max_plain(feats, keys, hw)
    if feats.device.type != "cuda":
        raise ValueError(f"segment_max runs on CPU or CUDA, not {feats.device}")
    B, N, C = feats.shape
    if keys.shape != (B, N) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{B}, {N}], got {keys.dtype} {tuple(keys.shape)}")
    dev = check_cuda_args(feats, keys)
    out = torch.empty(B, hw, C, dtype=feats.dtype, device=dev)
    KERNEL.launch("scatter_sorted_fwd", ptr(feats), ptr(keys), ptr(out), B, N, C, hw,
                  dtype_code(feats), stream_ptr(dev))
    return out


def bev_scatter_max_sorted(features: torch.Tensor, flat_idx: torch.Tensor,
                           valid: torch.Tensor, grid_size: Tuple[int, int]
                           ) -> torch.Tensor:
    """Scatter-max for CELL-SORTED points: features [B,N,C], flat_idx [B,N],
    valid [B,N] -> [B,H,W,C]; untouched cells exactly 0."""
    B, N, C = features.shape
    H, W = grid_size
    keys = cell_keys(flat_idx, valid, H * W)
    return segment_max(features.contiguous(), keys, H * W).reshape(B, H, W, C)


def sort_points_by_bev_cell(points: torch.Tensor, grid_size: Tuple[int, int],
                            pc_range, point_valid: Optional[torch.Tensor] = None):
    """Reorder points [B, N, D] by BEV cell id (invalid last) on the device.
    Returns (points_sorted, valid_sorted)."""
    H, W = grid_size
    flat_idx, valid = points_to_bev_indices(points[..., :2], grid_size, pc_range)
    if point_valid is not None:
        valid = valid & point_valid
    order = torch.argsort(cell_keys(flat_idx, valid, H * W), dim=-1, stable=True)
    pts = torch.gather(points, -2, order.unsqueeze(-1).expand(points.shape))
    return pts, torch.gather(valid, -1, order)
