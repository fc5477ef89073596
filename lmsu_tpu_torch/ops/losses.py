"""Loss functions: weighted cross-entropy (reference parity) and KD losses.

Counterpart of lmsu_tpu/ops/losses.py, in its layout: logits and feature
taps channels-last ([..., C]), targets [...] int.

Cross-entropy matches torch's `nn.CrossEntropyLoss(ignore_index=-1,
weight=class_weights)` of the reference (trainer.py:55) in its weighted
mean, sum(nll * w) / sum(w), but divides by max(sum(w), 1e-12) as the JAX
package does, so an all-ignored batch (a padded final batch can be one)
gives 0 where `F.cross_entropy` gives NaN.

Data parallelism (parallel/mesh.py): every mean here divides by a total of
the batch (the CE weights, the sample count, the sample weights). On a rank
of a data mesh they take `totals`, the global batch's totals reduced once a
step (`global_loss_totals`), so each rank's loss is its share of the global
loss: the shares sum to it, and the gradients sum over ranks. Without
`totals` (one process) nothing changes.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lmsu_tpu_torch.parallel.mesh import Mesh, all_reduce_, data_mesh


class LossTotals(NamedTuple):
    """The global batch's loss normalisers, on the device (f32 scalars)."""

    ce_weight: torch.Tensor      # sum of the CE pixel weights
    samples: torch.Tensor        # the global batch size
    sample_weight: torch.Tensor  # sum of the per-sample weights (samples when none)


def _ce_weights(targets: torch.Tensor, class_weights, ignore_index: int):
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, 0).long()
    if class_weights is None:
        return mask.float(), safe_t
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=targets.device)
    return torch.where(mask, cw[safe_t], 0.0), safe_t


def global_loss_totals(targets: torch.Tensor, class_weights=None, ignore_index: int = -1,
                       sample_weight: Optional[torch.Tensor] = None,
                       mesh: Optional[Mesh] = None) -> Optional[LossTotals]:
    """The totals of the global batch over `mesh` (default: the active data
    mesh), by one all-reduce of this rank's three; None at world size 1."""
    mesh = mesh if mesh is not None else data_mesh()
    if mesh is None or mesh.world_size == 1:
        return None
    w, _ = _ce_weights(targets, class_weights, ignore_index)
    B = targets.shape[0]
    sw = (sample_weight.float().sum() if sample_weight is not None
          else torch.tensor(float(B), device=targets.device))
    local = torch.stack([w.sum(), torch.tensor(float(B), device=targets.device), sw])
    tot = all_reduce_(local, mesh=mesh)
    return LossTotals(tot[0], tot[1], tot[2])


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           ignore_index: int = -1,
                           totals: Optional[LossTotals] = None) -> torch.Tensor:
    """Mean weighted CE over non-ignored pixels; f32 log-softmax.

    logits [..., C], targets [...] int (== ignore_index contributes nothing),
    class_weights [C] or None; `totals` divides by the global batch's CE
    weights."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    w, safe_t = _ce_weights(targets, class_weights, ignore_index)
    nll = -torch.gather(log_probs, -1, safe_t.unsqueeze(-1)).squeeze(-1)
    den = w.sum() if totals is None else totals.ce_weight
    return (nll * w).sum() / den.clamp(min=1e-12)


def _sample_weighted_mean(per_position: torch.Tensor,
                          sample_weight: Optional[torch.Tensor],
                          totals: Optional[LossTotals] = None) -> torch.Tensor:
    """Mean over [B, ...] values, weighting dim 0 by sample_weight [B] (the
    padding samples of a final partial batch get weight 0); over the global
    batch with `totals`."""
    if sample_weight is None:
        if totals is None:
            return per_position.mean()
        return per_position.sum() / (per_position[0].numel() * totals.samples)
    w = sample_weight.float()
    per_sample = per_position.reshape(per_position.shape[0], -1).mean(dim=1)
    den = w.sum() if totals is None else totals.sample_weight
    return (per_sample * w).sum() / den.clamp(min=1e-12)


def kd_logit_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                temperature: float = 2.0,
                sample_weight: Optional[torch.Tensor] = None,
                totals: Optional[LossTotals] = None) -> torch.Tensor:
    """Hinton-style distillation KL: T^2 * KL(softmax(t/T) || softmax(s/T)),
    mean over positions (optionally weighted per sample), in f32."""
    T = temperature
    s = F.log_softmax(student_logits.float() / T, dim=-1)
    t = F.log_softmax(teacher_logits.float() / T, dim=-1)
    kl = (t.exp() * (t - s)).sum(-1)
    return (T * T) * _sample_weighted_mean(kl, sample_weight, totals)


def feature_matching_loss(student_feat: torch.Tensor, teacher_feat: torch.Tensor,
                          projection: Optional[torch.Tensor] = None,
                          sample_weight: Optional[torch.Tensor] = None,
                          totals: Optional[LossTotals] = None) -> torch.Tensor:
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
    return _sample_weighted_mean((s - t).square(), sample_weight, totals)


def kd_total_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  student_feats: Mapping[str, torch.Tensor],
                  teacher_feats: Mapping[str, torch.Tensor], targets: torch.Tensor, *,
                  class_weights: Optional[torch.Tensor], ignore_index: int,
                  temperature: float, alpha_kl: float, beta_feature: float,
                  feature_taps: Sequence[str],
                  projections: Optional[Mapping[str, torch.Tensor]] = None,
                  sample_weight: Optional[torch.Tensor] = None,
                  totals: Optional[LossTotals] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE + alpha*KL + beta*mean(feature MSE). Returns (loss, parts). A
    coefficient that is the number 0 skips its term entirely."""
    ce = weighted_cross_entropy(student_logits, targets, class_weights, ignore_index, totals)
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    if isinstance(alpha_kl, (int, float)) and alpha_kl == 0.0:
        kl = zero
    else:
        kl = kd_logit_kl(student_logits, teacher_logits, temperature, sample_weight, totals)
    if isinstance(beta_feature, (int, float)) and beta_feature == 0.0:
        feature_taps = ()
    if feature_taps:
        fms = [feature_matching_loss(student_feats[tap], teacher_feats[tap],
                                     projections.get(tap) if projections is not None else None,
                                     sample_weight, totals)
               for tap in feature_taps]
        fm = torch.stack(fms).mean()
    else:
        fm = zero
    loss = ce + alpha_kl * kl + beta_feature * fm
    return loss, {"ce": ce, "kl": kl, "feature_mse": fm, "total": loss}
