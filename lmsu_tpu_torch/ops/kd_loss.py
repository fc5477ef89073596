"""KD feature-matching loss through the hand-written kernel
(csrc/kd_feature_mse.cu) and its plain PyTorch version.

Counterpart of lmsu_tpu/ops/kd_loss_pallas.py: replaces the TPU kernel
`_feature_mse_kernel` (per-sample sums of (S - T.P)^2, with T.P computed
inside the kernel) and carries `fused_feature_mse` (a Function whose
backward is the plain transcription of `_mse_bwd`) and
`kd_total_loss_fused`, a drop-in for ops/losses.py::kd_total_loss.

On the H100 the kernel is bound by its 2*M*Ct*Cs multiply-adds on CUDA
cores (f32); the design and its bound are in the .cu source note. Per-block
partials are summed in a fixed order, so the loss is deterministic.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, check_cuda_args,
                                      dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.losses import kd_logit_kl, weighted_cross_entropy

KERNEL = CudaKernel("kd_feature_mse.cu", {
    "kd_feature_mse": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "kd_feature_mse_partials_per_sample": (_I, _I)})


def mse_partials_plain(s3: torch.Tensor, t3: torch.Tensor,
                       projection: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: S [B, M, Cs], T [B, M, Ct], P [Ct, Cs]
    -> per-sample sums of (S - T.P)^2 [B], f32 arithmetic."""
    diff = s3.float() - t3.float() @ projection.float()
    return diff.square().sum(dim=(1, 2))


def mse_partials(s3: torch.Tensor, t3: torch.Tensor, projection: torch.Tensor
                 ) -> torch.Tensor:
    """Per-sample sums of (S - T.P)^2 [B] f32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if s3.device.type == "cpu":
        return mse_partials_plain(s3, t3, projection)
    if s3.device.type != "cuda":
        raise ValueError(f"mse_partials runs on CPU or CUDA, not {s3.device}")
    B, M, cs = s3.shape
    ct = t3.shape[-1]
    if t3.shape[:2] != (B, M) or t3.dtype != s3.dtype:
        raise ValueError("student and teacher taps must match in [B, M] and dtype")
    if projection.shape != (ct, cs):
        raise ValueError(f"projection must be [{ct}, {cs}], got {tuple(projection.shape)}")
    s3 = s3.contiguous()
    t3 = t3.contiguous()
    p = projection.float().contiguous()
    dev = check_cuda_args(s3, t3, p)
    n = KERNEL.lib().kd_feature_mse_partials_per_sample(ctypes.c_int(M), ctypes.c_int(cs))
    scratch = torch.empty(B, n, dtype=torch.float32, device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    KERNEL.launch("kd_feature_mse", ptr(s3), ptr(t3), ptr(p), ptr(scratch), ptr(out),
                  B, M, cs, ct, dtype_code(s3), stream_ptr(dev))
    return out


def _as_samples(x: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [B, M, C], keeping the batch dim (per-sample partials)."""
    c = x.shape[-1]
    return x.reshape(x.shape[0], -1, c) if x.dim() >= 3 else x.reshape(1, -1, c)


class _FusedFeatureMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, student, teacher, projection):
        s3 = _as_samples(student)
        partials = mse_partials(s3, _as_samples(teacher), projection)
        ctx.save_for_backward(student, teacher, projection)
        return partials.sum() / (s3[..., 0].numel() * student.shape[-1])

    @staticmethod
    def backward(ctx, g):
        """kd_loss_pallas.py::_mse_bwd: dS = 2/(M Cs) (S - T P),
        dT = -dS P^T, dP = -T^T dS, as dense f32 matmuls."""
        student, teacher, projection = ctx.saved_tensors
        cs, ct = student.shape[-1], teacher.shape[-1]
        s = student.reshape(-1, cs).float()
        t = teacher.reshape(-1, ct).float()
        p = projection.float()
        diff = s - t @ p
        sd = diff * (g * 2.0 / (s.shape[0] * cs))
        d_s = sd.reshape(student.shape).to(student.dtype) if ctx.needs_input_grad[0] else None
        d_t = ((-sd) @ p.T).reshape(teacher.shape).to(teacher.dtype) \
            if ctx.needs_input_grad[1] else None
        d_p = (-(t.T @ sd)).to(projection.dtype) if ctx.needs_input_grad[2] else None
        return d_s, d_t, d_p


def fused_feature_mse(student: torch.Tensor, teacher: torch.Tensor,
                      projection: torch.Tensor) -> torch.Tensor:
    """mean((student - teacher @ projection)^2) over all positions: student
    [..., Cs], teacher [..., Ct], projection [Ct, Cs]. Differentiable."""
    return _FusedFeatureMSE.apply(student, teacher, projection)


def kd_total_loss_fused(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                        student_feats: Mapping[str, torch.Tensor],
                        teacher_feats: Mapping[str, torch.Tensor], targets: torch.Tensor,
                        *, class_weights: Optional[torch.Tensor], ignore_index: int,
                        temperature: float, alpha_kl: float, beta_feature: float,
                        feature_taps: Sequence[str],
                        projections: Mapping[str, torch.Tensor],
                        sample_weight: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for ops/losses.py::kd_total_loss with the kernel's feature
    matching (kd_loss_pallas.py:183-228). Per-sample weights fold in
    algebraically: with binary w, sum(w (S - T P)^2) == sum((w S - (w T) P)^2),
    so weighted rows are masked first and the mean is rescaled from all
    samples to kept samples."""
    ce = weighted_cross_entropy(student_logits, targets, class_weights, ignore_index)
    kl = kd_logit_kl(student_logits, teacher_logits, temperature, sample_weight)
    if feature_taps:
        fms = []
        for tap in feature_taps:
            s, t = student_feats[tap], teacher_feats[tap]
            if sample_weight is None:
                fms.append(fused_feature_mse(s, t, projections[tap]))
            else:
                w = sample_weight.to(s.dtype)
                ws = w.reshape((-1,) + (1,) * (s.dim() - 1))
                wt = sample_weight.to(t.dtype).reshape((-1,) + (1,) * (t.dim() - 1))
                scale = (s[..., 0].numel() / sample_weight.float().sum().clamp(min=1e-12)
                         / float(s[0, ..., 0].numel()))
                fms.append(fused_feature_mse(s * ws, t * wt, projections[tap]) * scale)
        fm = torch.stack(fms).mean()
    else:
        fm = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + alpha_kl * kl + beta_feature * fm
    return loss, {"ce": ce, "kl": kl, "feature_mse": fm, "total": loss}
