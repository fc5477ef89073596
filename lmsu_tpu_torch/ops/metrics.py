"""Segmentation metrics: the confusion matrix on the device, IoU on the host,
and SegmentationMetrics, the reference's accumulator over both.

Counterpart of lmsu_tpu/ops/metrics.py (reference semantics,
trainer.py:9-37): pixels whose target is ignore_index, or whose target or
prediction lies outside [0, C), are dropped; rows are targets, columns
predictions. A class with an empty union scores 0 and still counts in the
mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(logits: torch.Tensor, targets: torch.Tensor, num_classes: int,
                     ignore_index: int = -1) -> torch.Tensor:
    """[C, C] int64 confusion counts on the logits' device. The counts go
    into a buffer of fixed size (dropped pixels into its last slot), so the
    host never waits for the device here; `torch.bincount` would read the
    indices' range back first."""
    preds = logits.argmax(dim=-1).reshape(-1).long()
    t = targets.reshape(-1).long()
    valid = (t != ignore_index) & (t >= 0) & (t < num_classes) \
        & (preds >= 0) & (preds < num_classes)
    idx = torch.where(valid, t * num_classes + preds, num_classes * num_classes)
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.long, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:num_classes * num_classes].reshape(num_classes, num_classes)


def iou_from_confusion(confusion) -> Dict[str, object]:
    """Per-class IoU + mIoU from a [C, C] matrix (reference: trainer.py:28-37)."""
    confusion = np.asarray(confusion, dtype=np.int64)
    tp = np.diag(confusion).astype(np.float64)
    fp = confusion.sum(axis=0) - tp
    fn = confusion.sum(axis=1) - tp
    denom = tp + fp + fn
    ious = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    return {"class_iou": [float(v) for v in ious], "miou": float(ious.mean())}


class SegmentationMetrics:
    """Host-side accumulator with the reference's interface (trainer.py:9-37),
    backed by the device confusion matrix: `update` takes logits [..., C]
    and targets (tensors on any device, or arrays), `update_confusion` a
    [C, C] matrix made elsewhere (a trainer's epoch sums), `compute` the
    per-class IoU and mIoU of everything accumulated."""

    def __init__(self, num_classes: int = 2, ignore_index: int = -1):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.confusion = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def update(self, logits, targets) -> None:
        logits = torch.as_tensor(logits)
        targets = torch.as_tensor(targets, device=logits.device)
        cm = confusion_matrix(logits, targets, self.num_classes, self.ignore_index)
        self.confusion += cm.cpu().numpy().astype(np.int64)

    def update_confusion(self, cm) -> None:
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        self.confusion += np.asarray(cm, dtype=np.int64)

    def compute(self) -> Dict[str, object]:
        return iou_from_confusion(self.confusion)
