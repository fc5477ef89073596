"""Weighted-fusion gate: the hand-written CUDA kernel (csrc/fusion_gate.cu)
and its plain PyTorch version.

Replaces the TPU kernel lmsu_tpu/ops/fusion_pallas.py::_gate_kernel
(forward of weighted_fusion_gate). Per BEV position:

    a   = cam . W1c + lid . W1l + b1      (the concat 1x1 conv, split)
    h   = relu(a)
    g   = sigmoid(h . (w2[0] - w2[1]) + b2[0] - b2[1])
    out = g * cam + (1 - g) * lid

On the H100 the f32 kernel is bound by its 2*M*2C*C multiply-adds on CUDA
cores; the design stages each row tile and K-chunks of W1 in shared memory
and keeps the gate reduction in registers (see the .cu source note); C of
32, 64, 128 and 256 take templated kernels, any other C a general one that
walks the output channels in tiles (as JAX's `_gate_forward` takes any C).
Weights are taken in the torch layout of the reference's `attention`
Sequential: w1 [C, 2C, 1, 1], b1 [C], w2 [2, C, 1, 1], b2 [2]. The kernel
reads them directly, so a forward needs no host sync and no weight copies.

`fusion_gate` is an autograd Function: the forward is the kernel (CUDA) or
the plain version (CPU); the backward is plain PyTorch on either device, a
transcription of the JAX package's `_gate_bwd` (fusion_pallas.py:141-175),
which recomputes a, h and g from the saved inputs (the JAX package has no
backward kernel for the gate either).
"""

from __future__ import annotations

import torch

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args,
                                      dtype_code, ptr, stream_ptr)

KERNEL = CudaKernel("fusion_gate.cu", {
    "fusion_gate_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)})


def fusion_gate_plain(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: cam/lid [..., C] -> [..., C], f32 arithmetic, output in
    the input dtype (the sigmoid form of the two-way softmax)."""
    C = cam.shape[-1]
    camf, lidf = cam.float(), lid.float()
    w = w1.reshape(C, 2 * C).float()
    a = camf @ w[:, :C].T + lidf @ w[:, C:].T + b1.float()
    w2f = w2.reshape(2, C).float()
    d = torch.relu(a) @ (w2f[0] - w2f[1]) + (b2[0] - b2[1]).float()
    g = torch.sigmoid(d).unsqueeze(-1)
    return (g * camf + (1.0 - g) * lidf).to(cam.dtype)


def fusion_gate_fwd(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                    ) -> torch.Tensor:
    """Gate forward on channels-last features cam/lid [..., C] (f32 or
    bf16): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Not differentiable; `fusion_gate` is."""
    if cam.device.type == "cpu":
        return fusion_gate_plain(cam, lid, w1, b1, w2, b2)
    if cam.device.type != "cuda":
        raise ValueError(f"fusion_gate runs on CPU or CUDA, not {cam.device}")
    C = cam.shape[-1]
    if lid.shape != cam.shape or lid.dtype != cam.dtype:
        raise ValueError("cam and lid must match in shape and dtype")
    if (w1.numel(), b1.numel(), w2.numel(), b2.numel()) != (2 * C * C, C, 2 * C, 2):
        raise ValueError("gate weights do not match the channel count")
    cam2 = cam.reshape(-1, C).contiguous()
    lid2 = lid.reshape(-1, C).contiguous()
    params = [t.contiguous() for t in (w1, b1, w2, b2)]
    dev = check_cuda_args(cam2, lid2, *params)
    for t in params:
        if t.dtype != torch.float32:
            raise TypeError("gate weights must be float32")
    out = torch.empty_like(cam2)
    KERNEL.launch("fusion_gate_fwd", ptr(cam2), ptr(lid2), *(ptr(t) for t in params),
                  ptr(out), cam2.shape[0], C, dtype_code(cam2), stream_ptr(dev))
    return out.reshape(cam.shape)


def fusion_gate_bwd(cam, lid, w1, b1, w2, b2, g_out):
    """Gradients of the gate w.r.t. (cam, lid, w1, b1, w2, b2), plain
    PyTorch in f32 (fusion_pallas.py::_gate_bwd in the torch layouts)."""
    C = cam.shape[-1]
    camf = cam.reshape(-1, C).float()
    lidf = lid.reshape(-1, C).float()
    go = g_out.reshape(-1, C).float()
    w = w1.reshape(C, 2 * C).float()
    w1c, w1l = w[:, :C], w[:, C:]                  # [C_out, C_in]
    w2f = w2.reshape(2, C).float()
    w2d = w2f[0] - w2f[1]
    a = camf @ w1c.T + lidf @ w1l.T + b1.float()
    h = torch.relu(a)
    g = torch.sigmoid(h @ w2d + (b2[0] - b2[1]).float()).unsqueeze(-1)
    # out = g*cam + (1-g)*lid
    s = (go * (camf - lidf)).sum(-1)               # dL/dg per row
    dd = s * (g[:, 0] * (1.0 - g[:, 0]))           # dL/dd
    da = torch.where(a > 0, dd[:, None] * w2d[None, :], 0.0)
    d_cam = (go * g + da @ w1c).to(cam.dtype).reshape(cam.shape)
    d_lid = (go * (1.0 - g) + da @ w1l).to(lid.dtype).reshape(lid.shape)
    d_w1 = torch.cat([da.T @ camf, da.T @ lidf], dim=1).reshape(w1.shape).to(w1.dtype)
    d_b1 = da.sum(0).to(b1.dtype)
    dw2col = h.T @ dd
    d_w2 = torch.stack([dw2col, -dw2col]).reshape(w2.shape).to(w2.dtype)
    sdd = dd.sum()
    d_b2 = torch.stack([sdd, -sdd]).to(b2.dtype)
    return d_cam, d_lid, d_w1, d_b1, d_w2, d_b2


class _FusionGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cam, lid, w1, b1, w2, b2):
        ctx.save_for_backward(cam, lid, w1, b1, w2, b2)
        return fusion_gate_fwd(cam, lid, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g_out):
        return fusion_gate_bwd(*ctx.saved_tensors, g_out)


def fusion_gate(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                ) -> torch.Tensor:
    """Fused gate on channels-last features cam/lid [..., C] (f32 or bf16),
    differentiable in every argument: the kernel (CUDA) or the plain
    version (CPU) forward, the plain backward."""
    return _FusionGate.apply(cam, lid, w1, b1, w2, b2)
