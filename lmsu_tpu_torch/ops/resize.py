"""Bilinear resize with `align_corners=False` (half-pixel) semantics.

Counterpart of lmsu_tpu/ops/resize.py, which matches the reference's
F.interpolate(..., mode="bilinear", align_corners=False) (reference:
fusion_module.py:62,88,103,124,240). Here it is that call itself, on NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize NCHW `x` to `size` = (H, W), half-pixel bilinear, no antialias."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)
