"""BEV scatter-max over UNSORTED points: the hand-written CUDA kernel
(csrc/voxelize_scatter_max.cu) and its plain PyTorch version.

Replaces the TPU kernel lmsu_tpu/ops/voxelize_pallas.py::_scatter_max_kernel
(bev_scatter_max_pallas, scatter_impl="pallas"). The TPU kernel keeps the
whole [H*W, C] grid of one image in VMEM and loops over the points one at a
time. The H100 has no 2 MB of fast memory per block, so the kernel splits
the channels instead: a persistent block walks (image, slice of channels)
items, keeps each item's [slice, H*W] accumulator in shared memory as
order-preserving integer keys and takes one shared-memory atomic max per
point and channel, with the next points' loads in flight meanwhile (see
the .cu source note). A max takes no rounding, so the result is exact and
deterministic in any order of the atomics.

The backward is the dense tie-splitting VJP (ops/scatter.py::
scatter_max_dense_bwd), plain PyTorch as in the JAX package, where it is jnp
and not a kernel. Points need no order.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args, check_device,
                                      define_op, dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.scatter import with_dense_vjp

KERNEL = CudaKernel("voxelize_scatter_max.cu", {
    "voxelize_scatter_max": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "voxelize_scatter_max_plan": (_I, _I, _I, _I, _I, _P)})


def scatter_max_plain(feats: torch.Tensor, idx: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain version of the kernel: feats [B, N, C], idx [B, N] int32 in
    [0, hw] (hw for invalid points) -> [B, hw, C] in the feature dtype. As
    the TPU kernel: an f32 -inf buffer with one junk row for the invalid
    points, a max per point, then -inf (a cell no point touched) becomes 0."""
    B, N, C = feats.shape
    acc = torch.full((B, hw + 1, C), float("-inf"), dtype=torch.float32, device=feats.device)
    acc.scatter_reduce_(1, idx.long().unsqueeze(-1).expand(B, N, C), feats.to(torch.float32),
                        "amax")
    acc = acc[:, :hw]
    return torch.where(torch.isneginf(acc), 0.0, acc).to(feats.dtype)


def scatter_max_plan(B: int, N: int, C: int, hw: int, dtype: torch.dtype) -> dict:
    """The kernel's launch for these shapes on the current card
    (chip_smoke.py prints it)."""
    o = (ctypes.c_int * 4)()
    err = KERNEL.lib().voxelize_scatter_max_plan(B, N, C, hw,
                                                 0 if dtype == torch.float32 else 1,
                                                 ctypes.addressof(o))
    if err:
        raise RuntimeError(f"voxelize_scatter_max_plan: CUDA error {err}")
    return {"slice": o[0], "smem_bytes": o[1], "blocks_per_sm": o[2], "blocks": o[3]}


def _scatter_max_cuda(feats: torch.Tensor, idx: torch.Tensor, hw: int) -> torch.Tensor:
    B, N, C = feats.shape
    if idx.shape != (B, N) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 [{B}, {N}], got {idx.dtype} {tuple(idx.shape)}")
    dev = check_cuda_args(feats, idx)
    out = torch.empty(B, hw, C, dtype=feats.dtype, device=dev)
    KERNEL.launch("voxelize_scatter_max", ptr(feats), ptr(idx), ptr(out), B, N, C, hw,
                  dtype_code(feats), stream_ptr(dev))
    return out


# K6 as the operator lmsu_tpu_torch::scatter_max (ops/_cuda.py::define_op).
_SCATTER_MAX = define_op(
    "scatter_max", "(Tensor feats, Tensor idx, int hw) -> Tensor",
    lambda feats, idx, hw: scatter_max_plain(feats, idx, hw), _scatter_max_cuda,
    lambda feats, idx, hw: feats.new_empty(feats.shape[0], hw, feats.shape[2]))


def scatter_max(feats: torch.Tensor, idx: torch.Tensor, hw: int) -> torch.Tensor:
    """Unsorted scatter-max: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. feats [B, N, C] f32/bf16, idx [B, N] int32."""
    check_device("scatter_max", feats)
    return _SCATTER_MAX(feats, idx, hw)


def _forward(features, flat_idx, valid, grid_size):
    B, N, C = features.shape
    H, W = grid_size
    idx = torch.where(valid, flat_idx, H * W).to(torch.int32).contiguous()
    return scatter_max(features.contiguous(), idx, H * W).reshape(B, H, W, C)


def bev_scatter_max_pallas(features: torch.Tensor, flat_idx: torch.Tensor,
                           valid: torch.Tensor, grid_size: Tuple[int, int]) -> torch.Tensor:
    """features [B,N,C], flat_idx [B,N], valid [B,N] -> [B,H,W,C], points in
    any order; untouched cells exactly 0. Differentiable in `features`."""
    return with_dense_vjp(_forward, features, flat_idx, valid, grid_size)
