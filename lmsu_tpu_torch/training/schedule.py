"""LR schedule with torch CosineAnnealingLR parity, stepped per EPOCH.

Counterpart of lmsu_tpu/training/schedule.py. The reference steps
CosineAnnealingLR(T_max=num_epochs, eta_min=1e-5) once per epoch
(trainer.py:59-61,166): during epoch e the LR is
  eta_min + (lr0 - eta_min) * (1 + cos(pi * e / T_max)) / 2,
and the per-step schedule floor-divides the step counter by
steps_per_epoch. The JAX package evaluates it in float32; so does this.
"""

from __future__ import annotations

import math

import numpy as np


def cosine_epoch_schedule(base_lr: float, eta_min: float, num_epochs: int,
                          steps_per_epoch: int):
    """step -> LR (a Python float holding the float32 value)."""
    def schedule(step: int) -> float:
        epoch = np.float32(min(step // steps_per_epoch, num_epochs))
        cos = np.cos(np.float32(np.pi) * epoch / np.float32(num_epochs))
        lr = np.float32(eta_min) + np.float32(base_lr - eta_min) \
            * (np.float32(1.0) + cos) / np.float32(2.0)
        return float(np.float32(lr))
    return schedule


def lr_at_epoch(base_lr: float, eta_min: float, num_epochs: int, epoch: int) -> float:
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * epoch / num_epochs)) / 2.0
