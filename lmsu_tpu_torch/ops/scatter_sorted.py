"""BEV scatter-max over CELL-SORTED points: the hand-written CUDA kernels
(csrc/scatter_sorted_fwd.cu, csrc/scatter_sorted_fwd_flat.cu,
csrc/scatter_sorted_bwd.cu) and their plain PyTorch versions, joined by an
autograd Function.

Replaces the TPU kernels lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel,
::_fwd_kernel_flat and ::_bwd_kernel (bev_scatter_max_sorted_pallas and its
custom VJP). On the H100 all three are bound by bytes: each feature row is
read once and each cell row written once (see the source notes in the .cu
files). With the points sorted by cell, each cell owns one contiguous span
of points. The forward (K1) and the backward (K5) share one walk over the
cell-sorted spans, split by cells (csrc/scatter_sorted_common.cuh; its
constants WALK_* and walk_geometry below): segmented passes over groups of
cells with no atomics. The flat forward (K4, taken when the module
constant `_FWD_FLAT` is set, as in the JAX package) computes the same
function split by points (its constants FLAT_* and flat_geometry below):
persistent blocks over fixed windows of sorted points, one pass over the
output (each window writes its runs and the empty cells before them), and
a second small launch that joins the runs crossing a block's edge from
their partial maxima. It does not consume the TPU kernel's chunk table;
the plain version segment_max_flat_plain keeps that route. All forwards
are bit-exact against any other max, and keep a NaN in its cell as the
JAX package's `xla` route does (a max that meets a NaN is NaN).

The backward splits a cell's gradient evenly over its tied winners, per
channel (the JAX package's dense-VJP parity rule):
d[p] = [feat[p] == out[cell]] * g[cell] / ties[cell]; invalid points get 0.
A NaN cell matches no point: its points get 0.

Input contract: `where(valid, flat_idx, H*W)` is non-decreasing along the
point axis of every batch row (invalid points last). The Predictor and the
serving engine sort on the host (data/rasterize.py::make_point_sorter);
`sort_points_by_bev_cell` below sorts on the device. Unsorted input gives
wrong results silently, as on the TPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, aligned16, check_cuda_args,
                                      check_device, define_op, dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.scatter import points_to_bev_indices, segmented_prefix_max

_PLAN = (_I, _I, _I, _I, _I, _I, _I, _P)
KERNEL = CudaKernel("scatter_sorted_fwd.cu", {
    "scatter_sorted_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "scatter_sorted_fwd_plan": _PLAN})
KERNEL_FLAT = CudaKernel("scatter_sorted_fwd_flat.cu", {
    "scatter_sorted_fwd_flat": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "scatter_sorted_fwd_flat_plan": (_I, _I, _I, _I, _I, _I, _P)})
KERNEL_BWD = CudaKernel("scatter_sorted_bwd.cu", {
    "scatter_sorted_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "scatter_sorted_bwd_plan": _PLAN})

# The span walk of K1 and K5 (csrc/scatter_sorted_common.cuh): the constants
# the wrappers pass to the kernels, which tests/test_torch_scatter_walk.py's
# emulation of the walk reads too. WALK_THREADS, WALK_SLICE_VECS and
# WALK_BUFFERS are the kernels' compile-time block size, widest channel
# slice (in vectors) and row buffers a stage, given here for walk_geometry.
WALK_THREADS = 256
WALK_SLICE_VECS = {"fwd": 128, "bwd": 32}
WALK_BUFFERS = {"fwd": 1, "bwd": 3}              # features; features, out, g
WALK_SLOT_BYTES = {"fwd": 24576, "bwd": 16384}  # a stage's buffer of feature rows
WALK_CELLS = 256   # cells a group at most


def walk_geometry(C: int, element_size: int, kind: str) -> dict:
    """What the walk of K1 (kind "fwd") or K5 ("bwd") decides from a row of
    C elements (as scatter_sorted_common.cuh::make_geometry): the vector
    bytes (the largest of 16, 8, 4, 2 dividing a row), channel slices of at
    most WALK_SLICE_VECS vectors (one walk each), threads a walker (a power
    of two up to 32, covering a slice's vectors), walkers a block; cap, the
    rows of a step: the slice rows that fit WALK_SLOT_BYTES, at least 1, at
    most WALK_THREADS - 1 (the key window is one key a thread), a cell of
    more being a long span; and long_rows, the rows of a long span's chunk
    (a stage's buffers end to end)."""
    rb = C * element_size
    vec = 16
    while rb % vec:
        vec //= 2
    total = rb // vec
    rowvec = min(total, WALK_SLICE_VECS[kind])
    lanes = 1
    while lanes < 32 and lanes < rowvec:
        lanes *= 2
    epv = vec // element_size
    rbs = rowvec * vec
    cap = max(1, min(WALK_SLOT_BYTES[kind] // rbs, WALK_THREADS - 1))
    return {"vec": vec, "epv": epv, "rowvec": rowvec, "cw": rowvec * epv,
            "slices": -(-total // rowvec), "lanes": lanes, "walkers": WALK_THREADS // lanes,
            "cap": cap, "long_rows": WALK_BUFFERS[kind] * (-(-cap * rbs // 16) * 16) // rbs}


_PLAN_KEYS = ("vector_bytes", "lanes", "walkers", "rows_per_step", "long_span_chunk_rows",
              "smem_bytes", "blocks_per_sm", "blocks", "slices")


def _plan(kernel: CudaKernel, symbol: str, slot_bytes: int, B, N, C, hw, dtype) -> dict:
    o = (ctypes.c_int * len(_PLAN_KEYS))()
    err = getattr(kernel.lib(), symbol)(B, N, C, hw, 0 if dtype == torch.float32 else 1,
                                        slot_bytes, WALK_CELLS, ctypes.addressof(o))
    if err:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return dict(zip(_PLAN_KEYS, o))


def segment_max_plan(B: int, N: int, C: int, hw: int, dtype: torch.dtype) -> dict:
    """K1's walk for these shapes on the current card (chip_smoke.py prints
    it): vector bytes, threads a walker, walkers, rows a step (a longer cell
    is a long span), rows a long span's chunk, shared memory a block,
    resident blocks per SM, blocks launched a slice, channel slices."""
    return _plan(KERNEL, "scatter_sorted_fwd_plan", WALK_SLOT_BYTES["fwd"], B, N, C, hw, dtype)


def segment_max_bwd_plan(B: int, N: int, C: int, hw: int, dtype: torch.dtype) -> dict:
    """K5's walk for these shapes, as segment_max_plan."""
    return _plan(KERNEL_BWD, "scatter_sorted_bwd_plan", WALK_SLOT_BYTES["bwd"], B, N, C, hw,
                 dtype)


# The flat forward K4 (csrc/scatter_sorted_fwd_flat.cu), split by points:
# the constants the wrapper passes to the kernel, which
# tests/test_torch_scatter_flat_walk.py's emulation of its plan reads too.
# A stage's buffer of feature rows (one window): FLAT_SLOT_BYTES, or
# FLAT_SLOT_BYTES_SMALL where the larger windows would give the persistent
# blocks fewer than FLAT_WINDOWS_A_BLOCK windows each. A small call (serving's
# B=8) is then cut finer, so that no block takes much more than its share
# and more blocks fit an SM; a large one keeps the fewer, longer windows.
FLAT_SLOT_BYTES = 24576
FLAT_SLOT_BYTES_SMALL = 16384
FLAT_WINDOWS_A_BLOCK = 4


def flat_geometry(C: int, element_size: int, slot_bytes: int = FLAT_SLOT_BYTES) -> dict:
    """What K4 decides from a row of C elements (as
    scatter_sorted_fwd_flat.cu::flat_geometry): K1's vectors, channel
    slices, threads a walker and walkers a block (walk_geometry's "fwd"
    kind), and chunk_rows, the sorted points a walker takes from a window,
    and window_rows = chunk_rows * walkers, the points a window (the rows of
    a window fit slot_bytes where one row a walker does, and a window holds
    at most WALK_THREADS keys, one a thread)."""
    g = walk_geometry(C, element_size, "fwd")
    rbs = g["rowvec"] * g["vec"]
    chunk = max(1, min(slot_bytes // rbs, WALK_THREADS) // g["walkers"])
    return {k: g[k] for k in ("vec", "epv", "rowvec", "cw", "slices", "lanes", "walkers")} | {
        "rbs": rbs, "chunk_rows": chunk, "window_rows": chunk * g["walkers"]}


def flat_block_windows(k: int, windows: int, grid: int) -> Tuple[int, int]:
    """The windows [g0, g1) of the flattened (image, window) list that
    block k of a persistent launch of `grid` blocks takes."""
    return windows * k // grid, windows * (k + 1) // grid


_FLAT_PLAN_KEYS = ("vector_bytes", "lanes", "walkers", "window_rows", "chunk_rows",
                   "smem_bytes", "blocks_per_sm", "blocks", "slices", "windows_per_image",
                   "workspace_bytes")
_FLAT_PLANS: dict = {}


def segment_max_flat_plan(B: int, N: int, C: int, hw: int, dtype: torch.dtype) -> dict:
    """K4's plan for these shapes on the current card (chip_smoke.py prints
    it; the wrapper caches it): the stage bytes it chose (FLAT_SLOT_BYTES,
    or FLAT_SLOT_BYTES_SMALL for a call that would give a block fewer than
    FLAT_WINDOWS_A_BLOCK windows), vector bytes, threads a walker,
    walkers, points a window and a walker's chunk, shared memory a block,
    resident blocks per SM, blocks launched a slice (the persistent grid),
    channel slices, windows an image, and the bytes of the workspace where
    blocks leave the partial maxima of the runs crossing their edges."""
    key = (torch.cuda.current_device(), B, N, C, hw, dtype)
    plan = _FLAT_PLANS.get(key)
    if plan is None:
        for slot in (FLAT_SLOT_BYTES, FLAT_SLOT_BYTES_SMALL):
            o = (ctypes.c_int * len(_FLAT_PLAN_KEYS))()
            err = KERNEL_FLAT.lib().scatter_sorted_fwd_flat_plan(
                B, N, C, hw, 0 if dtype == torch.float32 else 1, slot, ctypes.addressof(o))
            if err:
                raise RuntimeError(f"scatter_sorted_fwd_flat_plan: CUDA error {err}")
            plan = {"slot_bytes": slot, **dict(zip(_FLAT_PLAN_KEYS, o))}
            if B * plan["windows_per_image"] >= FLAT_WINDOWS_A_BLOCK * plan["blocks"]:
                break
        _FLAT_PLANS[key] = plan
    return dict(plan)


# The JAX package's switch between its two sorted forwards
# (lmsu_tpu/ops/scatter_sorted_pallas.py::_FWD_FLAT): False runs K1, True the
# flat forward K4. segment_max reads it at call time. The TPU kernel's chunk
# geometry is kept so that the plain version's chunk table is the same:
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


def _check_keys(feats: torch.Tensor, keys: torch.Tensor) -> None:
    B, N, _ = feats.shape
    if keys.shape != (B, N) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{B}, {N}], got {keys.dtype} {tuple(keys.shape)}")


def _segment_max_fake(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    return feats.new_empty(feats.shape[0], hw, feats.shape[2])


def _segment_max_cuda(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    B, N, C = feats.shape
    _check_keys(feats, keys)
    dev = check_cuda_args(feats, keys)
    feats = aligned16(feats)
    out = torch.empty(B, hw, C, dtype=feats.dtype, device=dev)
    KERNEL.launch("scatter_sorted_fwd", ptr(feats), ptr(keys), ptr(out), B, N, C, hw,
                  dtype_code(feats), WALK_SLOT_BYTES["fwd"], WALK_CELLS, stream_ptr(dev))
    return out


# K1 as the operator lmsu_tpu_torch::segment_max (ops/_cuda.py::define_op).
_SEGMENT_MAX = define_op("segment_max", "(Tensor feats, Tensor keys, int hw) -> Tensor",
                         lambda feats, keys, hw: segment_max_plain(feats, keys, hw),
                         _segment_max_cuda, _segment_max_fake)


def segment_max(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment max: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. feats [B, N, C] f32/bf16, keys [B, N] int32.
    With `_FWD_FLAT` set, the flat forward split by points (segment_max_flat)."""
    if _FWD_FLAT:
        return segment_max_flat(feats, keys, hw)
    check_device("segment_max", feats)
    return _SEGMENT_MAX(feats, keys, hw)


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


def _segment_max_flat_cuda(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    B, N, C = feats.shape
    _check_keys(feats, keys)
    dev = check_cuda_args(feats, keys)
    feats = aligned16(feats)
    plan = segment_max_flat_plan(B, N, C, hw, feats.dtype)
    out = torch.empty(B, hw, C, dtype=feats.dtype, device=dev)
    work = torch.empty(plan["workspace_bytes"], dtype=torch.uint8, device=dev)
    KERNEL_FLAT.launch("scatter_sorted_fwd_flat", ptr(feats), ptr(keys), ptr(out), ptr(work),
                       B, N, C, hw, dtype_code(feats), plan["slot_bytes"], plan["blocks"],
                       stream_ptr(dev))
    return out


# K4 as the operator lmsu_tpu_torch::segment_max_flat.
_SEGMENT_MAX_FLAT = define_op("segment_max_flat", "(Tensor feats, Tensor keys, int hw) -> Tensor",
                              lambda feats, keys, hw: segment_max_flat_plain(feats, keys, hw),
                              _segment_max_flat_cuda, _segment_max_fake)


def segment_max_flat(feats: torch.Tensor, keys: torch.Tensor, hw: int) -> torch.Tensor:
    """Sorted segment max split by points (K4): the CUDA kernel for CUDA
    tensors, the plain version (the TPU kernel's chunk-table route) for
    CPU tensors. feats [B, N, C] f32/bf16, keys [B, N] int32 sorted per
    row. One call of the C entry point: the walk over the windows, then
    the join of the runs that cross a block's edge."""
    check_device("segment_max_flat", feats)
    return _SEGMENT_MAX_FLAT(feats, keys, hw)


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
    feats, out, g = aligned16(feats), aligned16(out), aligned16(g)
    d = torch.empty_like(feats)
    KERNEL_BWD.launch("scatter_sorted_bwd", ptr(feats), ptr(keys), ptr(out), ptr(g), ptr(d),
                      B, N, C, hw, dtype_code(feats), WALK_SLOT_BYTES["bwd"], WALK_CELLS,
                      stream_ptr(dev))
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
