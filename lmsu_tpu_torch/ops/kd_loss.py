"""KD feature-matching loss through the hand-written kernel
(csrc/kd_feature_mse.cu) and its plain PyTorch version.

Counterpart of lmsu_tpu/ops/kd_loss_pallas.py: replaces the TPU kernel
`_feature_mse_kernel` (per-sample sums of (S - T.P)^2, with T.P computed
inside the kernel) and carries `fused_feature_mse` (a Function whose
backward is the plain transcription of `_mse_bwd`) and
`kd_total_loss_fused`, a drop-in for ops/losses.py::kd_total_loss.

On the H100 the kernel forms T.P on the bf16 tensor cores with split
operands: every f32 value v is written as a sum of bf16 terms v0 + v1 + v2,
each the bf16 rounding of what the earlier terms left (`split_bf16`), and
the products T_i.P_j with i + j < KERNEL_TERMS are summed in f32 (three
for bf16 taps, whose T is one exact term; six for f32 taps). That keeps
f32-level products (the residual of three terms is below 2^-24 of the
value). `mse_partials_emulated` repeats that arithmetic in plain PyTorch
for the tests and chip_smoke.py; the main path never calls it. The design
and its bound are in the .cu source note. Per-warp partials are summed in
a fixed order, so the loss is deterministic.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lmsu_tpu_torch.ops._cuda import (_I, _P, CudaKernel, aligned16, check_cuda_args,
                                      dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.losses import kd_logit_kl, weighted_cross_entropy

KERNEL = CudaKernel("kd_feature_mse.cu", {
    "kd_feature_mse": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "kd_feature_mse_partials_per_sample": (_I, _I)})

# bf16 terms per operand, and the kernel's products T_i . P_j with i + j <
# KERNEL_TERMS. Chosen with `mse_partials_emulated` on a student within
# 1e-3 of its projected teacher (tests/test_torch_kd_split.py): two terms
# leave more than the 1e-5 limit of the loss in f32 there, three less than
# a quarter of it.
KERNEL_TERMS = 3
_PAD = 64            # P's rows and columns are padded to multiples of this


def split_bf16(x: torch.Tensor, terms: int = KERNEL_TERMS) -> List[torch.Tensor]:
    """x (f32) as `terms` f32 tensors holding bf16 values whose sum is x up
    to the last residual: each term is the bf16 rounding (to nearest even)
    of what the earlier terms left, as the kernel splits its operands."""
    out, rest = [], x.float()
    for _ in range(terms):
        head = rest.to(torch.bfloat16).float()
        out.append(head)
        rest = rest - head
    return out


def kernel_products(dtype: torch.dtype) -> int:
    """Number of bf16 tensor-core products the kernel issues per T.P: T in
    bf16 is one exact term, f32 T is split like P."""
    t_terms = 1 if dtype == torch.bfloat16 else KERNEL_TERMS
    return sum(1 for i in range(t_terms) for j in range(KERNEL_TERMS) if i + j < KERNEL_TERMS)


def mse_partials_emulated(s3: torch.Tensor, t3: torch.Tensor, projection: torch.Tensor,
                          terms: int = KERNEL_TERMS) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (tests and chip_smoke.py
    only): T and P split into bf16 terms, the products T_i . P_j with
    i + j < terms summed in f32, then per-sample sums of (S - T.P)^2."""
    ts = split_bf16(t3.float(), 1 if t3.dtype == torch.bfloat16 else terms)
    ps = split_bf16(projection.float(), terms)
    acc = None
    for i, ti in enumerate(ts):
        for j, pj in enumerate(ps):
            if i + j < terms:
                prod = ti @ pj
                acc = prod if acc is None else acc + prod
    return (s3.float() - acc).square().sum(dim=(1, 2))


def fragment_terms(projection: torch.Tensor) -> torch.Tensor:
    """P [Ct, Cs] f32 -> the kernel's shared-memory image [Ctp/16,
    KERNEL_TERMS, Csp/8, 2, 8, 8] bf16, Ctp and Csp the next multiples of
    64: P split once into its bf16 terms (`split_bf16`), padded with zeros;
    for k-step s (16 rows) and term i, the warpgroup product's B operand
    without swizzle, K-major: core matrix (n-group ng, k-half h) holds
    P_i[16s + 8h + kk][8ng + nr] at [nr][kk] (8 rows of 16 bytes), and a
    kernel block reads the 8 n-groups of its 64 columns as one 2 KB run."""
    ct, cs = projection.shape
    ctp, csp = -(-ct // _PAD) * _PAD, -(-cs // _PAD) * _PAD
    terms = [F.pad(t, (0, csp - cs, 0, ctp - ct)).to(torch.bfloat16)
             .reshape(ctp // 16, 2, 8, csp // 8, 8).permute(0, 3, 1, 4, 2)
             for t in split_bf16(projection)]
    return torch.stack(terms, dim=1).contiguous()


def kd_feature_mse_limits(cs: int, ct: int) -> list:
    """What K7 cannot take for student / teacher tap widths (empty when it
    takes them)."""
    bad = []
    if cs % 8 or ct % 8:
        bad.append(f"Cs={cs}, Ct={ct} are not multiples of 8 (16-byte rows)")
    if ct > 512:
        bad.append(f"Ct={ct} > 512 (P's three bf16 terms fill a block's shared memory)")
    return bad


def check_kd_feature_mse(tap: str, cs: int, ct: int, teacher_width_mult: float) -> None:
    """Refuses, by tap, a feature-matching width K7 cannot take."""
    bad = kd_feature_mse_limits(cs, ct)
    if bad:
        raise ValueError(f"KD tap {tap!r} with KDConfig.teacher_width_mult="
                         f"{teacher_width_mult:g}: the feature-MSE kernel (KDConfig.use_pallas) "
                         f"cannot take it on the card: {'; '.join(bad)}; use use_pallas=False")


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
    bad = kd_feature_mse_limits(cs, ct)
    if bad:
        raise ValueError(f"kd_feature_mse kernel cannot take these taps: {'; '.join(bad)}")
    s3 = aligned16(s3.contiguous())
    t3 = aligned16(t3.contiguous())
    p = fragment_terms(projection)
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
            if s.dtype != t.dtype:
                # A bf16 teacher cache under f32 compute: the JAX kernel
                # computes in f32 (kd_loss_pallas.py::_mse_partials).
                s, t = s.float(), t.float()
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
