"""BEV scatter-max over CELL-SORTED points: the hand-written CUDA kernels
(csrc/scatter_sorted_fwd.cu, csrc/scatter_sorted_fwd_flat.cu,
csrc/scatter_sorted_bwd.cu) and their plain PyTorch versions, joined by an
autograd Function.

Replaces the TPU kernels lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel,
::_fwd_kernel_flat and ::_bwd_kernel (bev_scatter_max_sorted_pallas and its
custom VJP). On the H100 all three are bound by bytes: each feature row is
read once and each cell row written once (see the source notes in the .cu
files). With the points sorted by cell, each cell owns one contiguous span
of points. The per-tile forward (K1) and the backward are segmented passes
over cells with no atomics; the flat forward (K4, taken when the module
constant `_FWD_FLAT` is set, as in the JAX package) walks the TPU kernel's
static chunk table of fixed windows of points and combines a run that
crosses a window's edge with an atomic max. Both forwards are bit-exact
against any other max.

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
from lmsu_tpu_torch.ops.scatter import points_to_bev_indices, segmented_prefix_max

KERNEL = CudaKernel("scatter_sorted_fwd.cu", {
    "scatter_sorted_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P)})
KERNEL_FLAT = CudaKernel("scatter_sorted_fwd_flat.cu", {
    "scatter_sorted_fwd_flat": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)})
KERNEL_BWD = CudaKernel("scatter_sorted_bwd.cu", {
    "scatter_sorted_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)})

# The JAX package's switch between its two sorted forwards
# (lmsu_tpu/ops/scatter_sorted_pallas.py::_FWD_FLAT): False runs K1, True the
# flat chunk-table forward K4. segment_max reads it at call time. The TPU
# kernel's chunk geometry is kept so that the table is the same:
_FWD_FLAT = False
_TILE = 128     # output cells per tile
_CW_FWD = 256   # points per window of the flat forward
_CW_PAD = 256   # max(_CW, _CW_FWD) of the JAX package: the padding granularity


def _cdiv(a, b):
    return (a + b - 1) // b


def _align(dtype: torch.dtype) -> int:
    """The TPU kernel's sublane alignment of a window start: 8 rows for
    32-bit features, 16 for 16-bit (lmsu_tpu/ops/scatter_sorted_pallas.py::
    _align). It sets the table; the CUDA kernel needs no alignment."""
    return 8 if torch.empty((), dtype=dtype).element_size() >= 4 else 16


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
    x = segmented_prefix_max(feats, keys)
    last = (hi - 1).clamp(min=0).to(torch.int64)
    out = torch.gather(x, 1, last.unsqueeze(-1).expand(B, hw, C))
    return torch.where((hi > lo).unsqueeze(-1), out, torch.zeros((), dtype=feats.dtype,
                                                                   device=feats.device))


def segment_max(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment max: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. feats [B, N, C] f32/bf16, keys [B, N] int32.
    With `_FWD_FLAT` set, the flat chunk-table forward (segment_max_flat)."""
    if _FWD_FLAT:
        return segment_max_flat(feats, keys, hw)
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


def flat_prep(keys: torch.Tensor, hw: int):
    """The part of the TPU forward's _prep that the chunk table consumes
    (lmsu_tpu/ops/scatter_sorted_pallas.py:357-371): the padded length
    NP = round_up(N, 256) + 256 (the JAX package pads keys with the sentinel
    hw and features with 0 to it), the number of 128-cell tiles, and
    starts [B, ntiles + 1] int32, the first point of each tile
    (lower_bound of min(t * 128, hw) in the sorted keys; the sentinel
    padding would not move it). Returns (starts, NP, ntiles)."""
    B, N = keys.shape
    NP = _cdiv(N, _CW_PAD) * _CW_PAD + _CW_PAD
    ntiles = _cdiv(hw, _TILE)
    bounds = (torch.arange(ntiles + 1, dtype=torch.int32, device=keys.device) * _TILE
              ).clamp(max=hw)
    starts = torch.searchsorted(keys, bounds.expand(B, ntiles + 1).contiguous(), side="left")
    return starts.to(torch.int32), NP, ntiles


def chunk_table(starts: torch.Tensor, ntiles: int, NP: int, align: int, cw: int):
    """The flat forward's static (offset, tile) table, on the device with no
    host sync (lmsu_tpu/ops/scatter_sorted_pallas.py::_chunk_table). Tile
    t's span, its start aligned down to `align`, is cut into windows of cw
    points; the windows of all tiles, in order, fill S = ntiles +
    ceil((NP + ntiles * (align - 1)) / cw) slots, a bound on their number.
    Slots past the last window point at the all-sentinel tail (offset
    NP - cw, tile 0). Returns off [B, S], tile [B, S] int32 and S."""
    B = starts.shape[0]
    dev = starts.device
    w0 = torch.div(starts[:, :-1], align, rounding_mode="floor") * align
    span = starts[:, 1:] - w0
    nch = torch.div(span + cw - 1, cw, rounding_mode="floor")
    S = ntiles + _cdiv(NP + ntiles * (align - 1), cw)
    cum = torch.cat([torch.zeros(B, 1, dtype=torch.int32, device=dev),
                     torch.cumsum(nch, dim=1, dtype=torch.int32)], dim=1)
    s_iota = torch.arange(S, dtype=torch.int32, device=dev)
    tile = torch.searchsorted(cum, s_iota.expand(B, S).contiguous(), right=True) - 1
    pad = s_iota[None, :] >= cum[:, -1:]
    tile_c = tile.clamp(0, ntiles - 1).long()
    j = s_iota[None, :] - torch.gather(cum, 1, tile_c)
    off = torch.gather(w0, 1, tile_c) + j * cw
    off = torch.where(pad, NP - cw, off).to(torch.int32)
    tile = torch.where(pad, 0, tile_c).to(torch.int32)
    return off.contiguous(), tile.contiguous(), S


def segment_max_flat_plain(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain version of the flat kernel: the same function as
    segment_max_plain, by the TPU kernel's route (_fwd_kernel_flat): pad to
    NP, build the chunk table, then walk it slot by slot, all images at
    once: the window's segmented running max (equal sorted keys k apart lie
    in one run), each run's max at its last point in the window, placed at
    its cell if the cell lies in the slot's tile, max-accumulated into a
    -inf output of ntiles * 128 rows (rows >= hw take the sentinels and are
    sliced away); then -inf becomes 0."""
    B, N, C = feats.shape
    starts, NP, ntiles = flat_prep(keys, hw)
    off, tile, S = chunk_table(starts, ntiles, NP, _align(feats.dtype), _CW_FWD)
    keys_p = torch.nn.functional.pad(keys, (0, NP - N), value=hw)
    feats_p = torch.nn.functional.pad(feats, (0, 0, 0, NP - N))
    hw_pad = ntiles * _TILE
    out = torch.full((B, hw_pad + 1, C), float("-inf"), dtype=feats.dtype, device=feats.device)
    window = torch.arange(_CW_FWD, device=feats.device)
    for s in range(S):
        pos = off[:, s:s + 1].long() + window
        kc = torch.gather(keys_p, 1, pos)
        x = segmented_prefix_max(
            torch.gather(feats_p, 1, pos.unsqueeze(-1).expand(B, _CW_FWD, C)), kc)
        last = torch.cat([kc[:, :-1] != kc[:, 1:], torch.ones_like(kc[:, :1], dtype=torch.bool)],
                         dim=1)
        t0 = tile[:, s:s + 1] * _TILE
        rows = kc - t0
        place = last & (rows >= 0) & (rows < _TILE)
        dest = torch.where(place, kc, hw_pad).long()
        out.scatter_reduce_(1, dest.unsqueeze(-1).expand(B, _CW_FWD, C), x, "amax")
    out = out[:, :hw]
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype,
                                                        device=out.device), out)


def segment_max_flat(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment max by the flat chunk table: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. feats [B, N, C] f32/bf16,
    keys [B, N] int32 sorted per row."""
    if feats.device.type == "cpu":
        return segment_max_flat_plain(feats, keys, hw)
    if feats.device.type != "cuda":
        raise ValueError(f"segment_max_flat runs on CPU or CUDA, not {feats.device}")
    B, N, C = feats.shape
    if keys.shape != (B, N) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{B}, {N}], got {keys.dtype} {tuple(keys.shape)}")
    dev = check_cuda_args(feats, keys)
    starts, NP, ntiles = flat_prep(keys, hw)
    off, tile, S = chunk_table(starts, ntiles, NP, _align(feats.dtype), _CW_FWD)
    out = torch.empty(B, hw, C, dtype=feats.dtype, device=dev)
    KERNEL_FLAT.launch("scatter_sorted_fwd_flat", ptr(feats), ptr(keys), ptr(off), ptr(tile),
                       ptr(out), B, N, C, hw, S, _CW_FWD, _TILE, dtype_code(feats),
                       stream_ptr(dev))
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


def bev_scatter_max_sorted_pallas(features: torch.Tensor, flat_idx: torch.Tensor,
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
