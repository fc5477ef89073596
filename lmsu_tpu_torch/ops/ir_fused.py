"""Fused InvertedResidual block for inference: the hand-written CUDA kernel
(csrc/ir_fused_infer.cu) and its plain PyTorch version.

Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_ir_infer_kernel (with
the chunk loop and glue of fused_ir_infer). With BN running statistics
folded into per-channel scale/bias:

    e   = relu6((x @ W1) * s1 + b1)           expand 1x1 (absent at expansion 1)
    d   = relu6(dw3x3(e, stride) * s2 + b2)   depthwise, padding 1
    out = (d @ W2) * s3 + b3  (+ x if stride 1 and Cin == Cout)

On the H100 the f32 kernel is bound by its multiply-adds on CUDA cores
(the expansion-1 stage by bytes); its design keeps the 6x-expanded hidden
tensor in shared memory and runs the whole block in one launch (two when
a small grid splits its hidden channels; see the .cu source note).
Rounding follows the TPU kernel: e, the depthwise taps and d are rounded to
the input dtype, every sum is f32, and the residual is added in the input
dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args,
                                      dtype_code, ptr, stream_ptr)

KERNEL = CudaKernel("ir_fused_infer.cu", {
    "ir_fused_infer": (_P,) * 12 + (_I,) * 13 + (_P,)})

_SMEM_LIMIT = 232448          # shared memory a block may opt in to on Hopper
_SMEM_PER_SM = 233472         # shared memory of one Hopper SM


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BN(stats) == x * scale + bias, with rsqrt as the JAX package folds."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


class IRParams(NamedTuple):
    """Folded block parameters, in the JAX package's layout: w1 [Cin, Ce]
    (None at expansion 1), dw [3, 3, Ce], w2 [Ce, Cout]; scales and biases
    per channel."""
    w1: Optional[torch.Tensor]
    s1: Optional[torch.Tensor]
    b1: Optional[torch.Tensor]
    dw: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def fused_ir_infer_plain(x: torch.Tensor, p: IRParams, stride: int) -> torch.Tensor:
    """Plain version: x [B, H, W, Cin] NHWC -> [B, Ho, Wo, Cout]."""
    dt = x.dtype
    Cin, Cout = x.shape[-1], p.w2.shape[-1]
    if p.w1 is not None:
        e = x.float() @ p.w1.to(dt).float()
        e_act = _relu6(e * p.s1.float() + p.b1.float()).to(dt)
    else:
        e_act = x
    ce = e_act.shape[-1]
    dw = p.dw.to(dt).float().permute(2, 0, 1).unsqueeze(1)          # [Ce, 1, 3, 3]
    d = F.conv2d(e_act.float().permute(0, 3, 1, 2), dw, stride=stride, padding=1,
                 groups=ce).permute(0, 2, 3, 1)
    d = _relu6(d * p.s2.float() + p.b2.float()).to(dt)
    y = d.float() @ p.w2.to(dt).float()
    out = (y * p.s3.float() + p.b3.float()).to(dt)
    if stride == 1 and Cin == Cout:
        out = x + out
    return out


def _smem_bytes(stride: int, cin: int, cout: int) -> int:
    """The kernel's shared memory: halo tile (transposed, padded), one
    32-channel chunk of e, W1, d and W2 (see the layout in the .cu file)."""
    pin = (7 * stride + 3) ** 2
    ppad = (pin + 3) // 4 * 4
    while ppad % 32 != 4:
        ppad += 4
    return 4 * (cin * ppad + pin * 32 + cin * 32 + 32 * 68 + 32 * cout)


def _hidden_split(blocks: int, smem: int, ce: int, device: torch.device) -> int:
    """How many blocks share one tile's hidden chunks: enough that the grid
    fills every SM as far as shared memory lets blocks co-reside (the 32x32
    stages give only B*16 tiles). 1 = no split."""
    per_sm = max(1, _SMEM_PER_SM // (smem + 1024))
    slots = torch.cuda.get_device_properties(device).multi_processor_count * per_sm
    return max(1, min((ce + 31) // 32, slots // blocks))


def fused_ir_infer(x: torch.Tensor, p: IRParams, stride: int = 1) -> torch.Tensor:
    """Fused eval InvertedResidual on NHWC x [B, H, W, Cin] (f32 or bf16):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_ir_infer_plain(x, p, stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ir_infer runs on CPU or CUDA, not {x.device}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    B, H, W, Cin = x.shape
    Ce, Cout = p.dw.shape[-1], p.w2.shape[-1]
    has_expand = p.w1 is not None
    if not has_expand and Ce != Cin:
        raise ValueError("expansion-1 block must have Ce == Cin")
    if Cout > 256 or Cin % 4 or Ce % 4 or Cout % 4:
        raise ValueError(f"fused_ir_infer kernel takes channel counts that are multiples "
                         f"of 4 and Cout <= 256, got Cin={Cin}, Ce={Ce}, Cout={Cout}")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    dt = x.dtype
    x = x.contiguous()
    f32 = [t.float().contiguous() for t in (p.s2, p.b2, p.s3, p.b3)]
    # Weights and taps hold values of the input dtype, passed as f32.
    dw = p.dw.to(dt).float().reshape(9, Ce).contiguous()
    w2 = p.w2.to(dt).float().contiguous()
    if has_expand:
        w1 = p.w1.to(dt).float().contiguous()
        s1, b1 = p.s1.float().contiguous(), p.b1.float().contiguous()
        dev = check_cuda_args(x, w1, s1, b1, dw, w2, *f32)
    else:
        w1 = s1 = b1 = None
        dev = check_cuda_args(x, dw, w2, *f32)
    smem = _smem_bytes(stride, Cin, Cout)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused IR block too wide for shared memory (Cin={Cin}, "
                         f"Cout={Cout}, stride {stride}); use fused_inference=False")
    nsplit = _hidden_split(B * -(-Ho // 8) * -(-Wo // 8), smem, Ce, dev)
    out = torch.empty(B, Ho, Wo, Cout, dtype=dt, device=dev)
    partial = (torch.empty(nsplit, B, Ho, Wo, Cout, dtype=torch.float32, device=dev)
               if nsplit > 1 else None)
    residual = int(stride == 1 and Cin == Cout)
    KERNEL.launch("ir_fused_infer", ptr(x), ptr(w1), ptr(s1), ptr(b1), ptr(dw),
                  ptr(f32[0]), ptr(f32[1]), ptr(w2), ptr(f32[2]), ptr(f32[3]), ptr(out),
                  ptr(partial), B, H, W, Ho, Wo, Cin, Ce, Cout, stride, int(has_expand),
                  residual, nsplit, dtype_code(x), stream_ptr(dev))
    return out
