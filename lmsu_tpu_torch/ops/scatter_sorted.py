"""BEV scatter-max over CELL-SORTED points: the hand-written CUDA kernels
(csrc/scatter_sorted_fwd.cu, csrc/scatter_sorted_bwd.cu) and their plain
PyTorch versions, joined by an autograd Function.

Replaces the TPU kernels lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel
and ::_bwd_kernel (bev_scatter_max_sorted_pallas and its custom VJP). On the
H100 both are bound by bytes: each feature row is read once and each cell
row written once (see the source notes in the .cu files). With the points
sorted by cell, each cell owns one contiguous span of points, so both
kernels are segmented passes with no atomics: deterministic, and the
forward is bit-exact against any other max.

The backward splits a cell's gradient evenly over its tied winners, per
channel (the JAX package's dense-VJP parity rule):
d[p] = [feat[p] == out[cell]] * g[cell] / ties[cell]; invalid points get 0.

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
KERNEL_BWD = CudaKernel("scatter_sorted_bwd.cu", {
    "scatter_sorted_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)})


def cell_keys(flat_idx: torch.Tensor, valid: torch.Tensor, hw: int) -> torch.Tensor:
    """Per-point sort key [B, N] int32: the cell id, or hw for invalid points."""
    return torch.where(valid, flat_idx, hw).to(torch.int32).contiguous()


def _spans(keys: torch.Tensor, hw: int) -> torch.Tensor:
    """[B, hw + 1] start of each cell's span in the sorted keys (binary search)."""
    cells = torch.arange(hw + 1, device=keys.device, dtype=keys.dtype)
    return torch.searchsorted(keys, cells.expand(keys.shape[0], hw + 1).contiguous(),
                              side="left")


def segment_max_plain(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain version of the kernel: feats [B, N, C], sorted keys [B, N] ->
    [B, hw, C]. Same algorithm: each cell's span from a binary search of the
    sorted keys, then the max over the span (a segmented prefix max read at
    the span's last point); empty spans are 0."""
    B, N, C = feats.shape
    bounds = _spans(keys, hw)
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


def segment_max_bwd_plain(feats: torch.Tensor, keys: torch.Tensor, out: torch.Tensor,
                          g: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain version of the backward kernel: feats [B, N, C], sorted keys
    [B, N], out and g [B, hw, C] -> d_feats [B, N, C] in the feature dtype.
    Same algorithm: spans from a binary search of the sorted keys, out and g
    gathered per point by its key, winners counted per cell and channel as
    differences of a running count at the span ends."""
    B, N, C = feats.shape
    valid = (keys < hw).unsqueeze(-1)
    k = keys.clamp(max=hw - 1).long().unsqueeze(-1).expand(B, N, C)
    win = (feats.float() == torch.gather(out, 1, k).float()) & valid
    run = torch.cat([win.new_zeros(B, 1, C, dtype=torch.int32),
                     win.to(torch.int32).cumsum(1, dtype=torch.int32)], dim=1)
    bounds = _spans(keys, hw).long().unsqueeze(-1).expand(B, hw + 1, C)
    ties = torch.gather(run, 1, bounds[:, 1:]) - torch.gather(run, 1, bounds[:, :-1])
    share = g.to(out.dtype).float() / ties.clamp(min=1).float()
    return torch.where(win, torch.gather(share, 1, k), 0.0).to(feats.dtype)


def segment_max_bwd(feats: torch.Tensor, keys: torch.Tensor, out: torch.Tensor,
                    g: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment-max backward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if feats.device.type == "cpu":
        return segment_max_bwd_plain(feats, keys, out, g, hw)
    if feats.device.type != "cuda":
        raise ValueError(f"segment_max_bwd runs on CPU or CUDA, not {feats.device}")
    B, N, C = feats.shape
    if keys.shape != (B, N) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{B}, {N}], got {keys.dtype} {tuple(keys.shape)}")
    if out.shape != (B, hw, C) or out.dtype != feats.dtype:
        raise ValueError("out must be [B, hw, C] in the feature dtype")
    g = g.to(out.dtype).reshape(B, hw, C).contiguous()
    dev = check_cuda_args(feats, keys, out, g)
    d = torch.empty_like(feats)
    KERNEL_BWD.launch("scatter_sorted_bwd", ptr(feats), ptr(keys), ptr(out), ptr(g), ptr(d),
                      B, N, C, hw, dtype_code(feats), stream_ptr(dev))
    return d


class _SortedScatterMax(torch.autograd.Function):
    """segment_max with the tie-splitting backward (both kernels on CUDA)."""

    @staticmethod
    def forward(ctx, feats, keys, hw):
        out = segment_max(feats, keys, hw)
        ctx.save_for_backward(feats, keys, out)
        ctx.hw = hw
        return out

    @staticmethod
    def backward(ctx, g):
        feats, keys, out = ctx.saved_tensors
        return segment_max_bwd(feats, keys, out, g, ctx.hw), None, None


def bev_scatter_max_sorted(features: torch.Tensor, flat_idx: torch.Tensor,
                           valid: torch.Tensor, grid_size: Tuple[int, int]
                           ) -> torch.Tensor:
    """Scatter-max for CELL-SORTED points: features [B,N,C], flat_idx [B,N],
    valid [B,N] -> [B,H,W,C]; untouched cells exactly 0. Differentiable in
    `features`."""
    B, N, C = features.shape
    H, W = grid_size
    keys = cell_keys(flat_idx, valid, H * W)
    return _SortedScatterMax.apply(features.contiguous(), keys, H * W).reshape(B, H, W, C)


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
