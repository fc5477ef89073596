"""Weighted-fusion gate: the hand-written CUDA kernel (csrc/fusion_gate.cu)
and its plain PyTorch version.

Replaces the TPU kernel lmsu_tpu/ops/fusion_pallas.py::_gate_kernel
(forward of weighted_fusion_gate). Per BEV position:

    a   = cam . W1c + lid . W1l + b1      (the concat 1x1 conv, split)
    h   = relu(a)
    g   = sigmoid(h . (w2[0] - w2[1]) + b2[0] - b2[1])
    out = g * cam + (1 - g) * lid

On the H100 the kernel forms the 2C x C product on the bf16 tensor cores
(mma.sync) with W1 split into GATE_TERMS bf16 terms, since W1 stays f32 for
both feature types as in the TPU kernel; f32 features are split the same
way, bf16 features are one exact term (`gate_products`). A block stages a
tile of rows in shared memory, walks all C output channels, reduces each
row's gate logit inside the block and blends from the staged rows, so cam
and lid are read once and out written once: bytes bound it at C=128, the
products at the teacher's C=256 (see the .cu source note).
`fusion_gate_emulated` repeats the kernel's split arithmetic in plain
PyTorch for the tests. Every C runs, as JAX's `_gate_forward` takes any C:
a C whose 32-row tile does not fit a block's shared memory (past 512
channels in f32, 1,024 in bf16) streams x through the kernel's ring in
every pass instead, with the same arithmetic.
Weights are taken in the torch layout of the reference's `attention`
Sequential: w1 [C, 2C, 1, 1], b1 [C], w2 [2, C, 1, 1], b2 [2]. The kernel
library splits W1 on the device in the same launch, so a forward needs no
host sync and no weight copies.

`fusion_gate` is an autograd Function: the forward is the kernel (CUDA) or
the plain version (CPU); the backward is plain PyTorch on either device, a
transcription of the JAX package's `_gate_bwd` (fusion_pallas.py:141-175),
which recomputes a, h and g from the saved inputs (the JAX package has no
backward kernel for the gate either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args, check_device,
                                      define_op, dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.kd_loss import split_bf16

KERNEL = CudaKernel("fusion_gate.cu", {
    "fusion_gate_fwd": (_P,) * 8 + (_I,) * 3 + (_P,),
    "fusion_gate_frag_uint2": (_I,),
    "fusion_gate_rows": (_I,) * 2,
    "fusion_gate_warps": (_I,) * 2,
    "fusion_gate_streams": (_I,) * 2,
    "fusion_gate_smem": (_I,) * 2,
    "fusion_gate_occupancy": (_I,) * 2})

# bf16 terms of W1 (and of f32 features): products x_i . W_j with i + j <
# GATE_TERMS. Chosen with `gate_logits_emulated` at the student's and the
# teacher's widths (tests/test_torch_fusion_gate.py): two terms leave a more
# than 1e-6 of its scale from the float64 product, three well inside it.
GATE_TERMS = 3


def gate_products(dtype: torch.dtype) -> int:
    """bf16 tensor-core products the kernel issues per f32-level product:
    W1 is GATE_TERMS terms in both types, f32 features as many, bf16
    features one exact term."""
    x_terms = 1 if dtype == torch.bfloat16 else GATE_TERMS
    return sum(1 for i in range(x_terms) for j in range(GATE_TERMS) if i + j < GATE_TERMS)


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


def gate_logits_emulated(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, terms: int = GATE_TERMS) -> torch.Tensor:
    """a = [cam | lid] . W1^T + b1 [M, C] as the kernel forms it, in plain
    PyTorch (tests only; the main path never calls it): K = [cam channels
    padded to 16 | lid channels padded to 16], W1 split into `terms` bf16
    terms, f32 features as many and bf16 features one exact term; per
    16-deep k-step the products x_i W_j (i + j < terms) summed smallest
    first into a fresh f32 sum, each k-step's sum added to the running
    total, then b1."""
    C = cam.shape[-1]
    pad = -(-C // 16) * 16 - C
    x = torch.cat([F.pad(cam.reshape(-1, C).float(), (0, pad)),
                   F.pad(lid.reshape(-1, C).float(), (0, pad))], dim=1)
    w = w1.reshape(C, 2 * C).float()
    wt = torch.cat([F.pad(w[:, :C].T, (0, 0, 0, pad)), F.pad(w[:, C:].T, (0, 0, 0, pad))])
    xs = [x] if cam.dtype == torch.bfloat16 else split_bf16(x, terms)
    ws = split_bf16(wt, terms)
    pairs = [(i, s - i) for s in range(terms - 1, -1, -1) for i in range(terms - 1, -1, -1)
             if 0 <= s - i < len(ws) and i < len(xs)]
    acc = None
    for k0 in range(0, x.shape[1], 16):
        tmp = None
        for i, j in pairs:
            prod = xs[i][:, k0:k0 + 16] @ ws[j][k0:k0 + 16]
            tmp = prod if tmp is None else tmp + prod
        acc = tmp if acc is None else acc + tmp
    return acc + b1.float()


def fusion_gate_emulated(cam, lid, w1, b1, w2, b2, terms: int = GATE_TERMS) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (tests only): the plain
    version with a from `gate_logits_emulated`."""
    C = cam.shape[-1]
    a = gate_logits_emulated(cam, lid, w1, b1, terms)
    w2f = w2.reshape(2, C).float()
    d = torch.relu(a) @ (w2f[0] - w2f[1]) + (b2[0] - b2[1]).float()
    g = torch.sigmoid(d).unsqueeze(-1)
    out = g * cam.reshape(-1, C).float() + (1.0 - g) * lid.reshape(-1, C).float()
    return out.to(cam.dtype).reshape(cam.shape)


def _fusion_gate_cuda(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
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
    frag = torch.empty(KERNEL.lib().fusion_gate_frag_uint2(C), 2, dtype=torch.int32, device=dev)
    out = torch.empty_like(cam2)
    KERNEL.launch("fusion_gate_fwd", ptr(cam2), ptr(lid2), *(ptr(t) for t in params),
                  ptr(frag), ptr(out), cam2.shape[0], C, dtype_code(cam2), stream_ptr(dev))
    return out.reshape(cam.shape)


# K2 as the operator lmsu_tpu_torch::fusion_gate (ops/_cuda.py::define_op).
_FUSION_GATE = define_op(
    "fusion_gate", "(Tensor cam, Tensor lid, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    lambda *a: fusion_gate_plain(*a), _fusion_gate_cuda,
    lambda cam, *_: torch.empty_like(cam, memory_format=torch.contiguous_format))


def fusion_gate_fwd(cam: torch.Tensor, lid: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                    ) -> torch.Tensor:
    """Gate forward on channels-last features cam/lid [..., C] (f32 or
    bf16): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Not differentiable; `fusion_gate` is."""
    check_device("fusion_gate", cam)
    return _FUSION_GATE(cam, lid, w1, b1, w2, b2)


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
