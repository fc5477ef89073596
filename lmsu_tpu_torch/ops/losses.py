"""Loss functions: weighted cross-entropy (reference parity) and KD losses.

Counterpart of lmsu_tpu/ops/losses.py, in its layout: logits and feature
taps channels-last ([..., C]), targets [...] int.

Cross-entropy matches torch's `nn.CrossEntropyLoss(ignore_index=-1,
weight=class_weights)` of the reference (trainer.py:55) in its weighted
mean, sum(nll * w) / sum(w), but divides by max(sum(w), 1e-12) as the JAX
package does, so an all-ignored batch (a padded final batch can be one)
gives 0 where `F.cross_entropy` gives NaN.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           ignore_index: int = -1) -> torch.Tensor:
    """Mean weighted CE over non-ignored pixels; f32 log-softmax.

    logits [..., C], targets [...] int (== ignore_index contributes nothing),
    class_weights [C] or None."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, 0).long()
    nll = -torch.gather(log_probs, -1, safe_t.unsqueeze(-1)).squeeze(-1)
    if class_weights is None:
        w = mask.float()
    else:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
        w = torch.where(mask, cw[safe_t], 0.0)
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def _sample_weighted_mean(per_position: torch.Tensor,
                          sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over [B, ...] values, weighting dim 0 by sample_weight [B] (the
    padding samples of a final partial batch get weight 0)."""
    if sample_weight is None:
        return per_position.mean()
    w = sample_weight.float()
    per_sample = per_position.reshape(per_position.shape[0], -1).mean(dim=1)
    return (per_sample * w).sum() / w.sum().clamp(min=1e-12)


def kd_logit_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                temperature: float = 2.0,
                sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hinton-style distillation KL: T^2 * KL(softmax(t/T) || softmax(s/T)),
    mean over positions (optionally weighted per sample), in f32."""
    T = temperature
    s = F.log_softmax(student_logits.float() / T, dim=-1)
    t = F.log_softmax(teacher_logits.float() / T, dim=-1)
    kl = (t.exp() * (t - s)).sum(-1)
    return (T * T) * _sample_weighted_mean(kl, sample_weight)


def feature_matching_loss(student_feat: torch.Tensor, teacher_feat: torch.Tensor,
                          projection: Optional[torch.Tensor] = None,
                          sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE between the student tap [..., Cs] and the teacher tap [..., Ct],
    projected by [Ct, Cs] when given. The projection is rounded to the tap's
    dtype and the product accumulated in f32, as the JAX package's einsum
    with preferred_element_type=f32 does (a bf16 x bf16 product is exact in
    f32, so upcasting the operands first changes nothing)."""
    if projection is not None:
        t = teacher_feat.float() @ projection.to(teacher_feat.dtype).float()
    else:
        t = teacher_feat.float()
    s = student_feat.float()
    return _sample_weighted_mean((s - t).square(), sample_weight)


def kd_total_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  student_feats: Mapping[str, torch.Tensor],
                  teacher_feats: Mapping[str, torch.Tensor], targets: torch.Tensor, *,
                  class_weights: Optional[torch.Tensor], ignore_index: int,
                  temperature: float, alpha_kl: float, beta_feature: float,
                  feature_taps: Sequence[str],
                  projections: Optional[Mapping[str, torch.Tensor]] = None,
                  sample_weight: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE + alpha*KL + beta*mean(feature MSE). Returns (loss, parts). A
    coefficient that is the number 0 skips its term entirely."""
    ce = weighted_cross_entropy(student_logits, targets, class_weights, ignore_index)
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    if isinstance(alpha_kl, (int, float)) and alpha_kl == 0.0:
        kl = zero
    else:
        kl = kd_logit_kl(student_logits, teacher_logits, temperature, sample_weight)
    if isinstance(beta_feature, (int, float)) and beta_feature == 0.0:
        feature_taps = ()
    if feature_taps:
        fms = [feature_matching_loss(student_feats[tap], teacher_feats[tap],
                                     projections.get(tap) if projections is not None else None,
                                     sample_weight)
               for tap in feature_taps]
        fm = torch.stack(fms).mean()
    else:
        fm = zero
    loss = ce + alpha_kl * kl + beta_feature * fm
    return loss, {"ce": ce, "kl": kl, "feature_mse": fm, "total": loss}
