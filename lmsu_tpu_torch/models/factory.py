"""Model construction, seeded initialisation and parameter accounting.

Counterpart of lmsu_tpu/models/factory.py. Initialisation draws from one
torch.Generator seeded by the caller: convolutions He-normal on fan-out (the
JAX package's variance_scaling(2, fan_out)), biases zero, BatchNorm at
identity. The two packages draw different numbers from the same seed; tests
share weights through utils/weights.py instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.models.fusion import CompleteSegmentationModel

# What this slice of the port runs; other values are not ported yet.
_SUPPORTED = {"fusion_type": ("weighted",), "output_mode": ("same",)}


def _check_supported(config: ModelConfig) -> None:
    for field, allowed in _SUPPORTED.items():
        if getattr(config, field) not in allowed:
            raise NotImplementedError(
                f"{field}={getattr(config, field)!r} is not ported yet "
                f"(supported: {allowed})")
    if config.camera.remat:
        raise NotImplementedError("remat is a training option that is not ported yet")
    if config.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{config.compute_dtype}")


def create_model(config: Optional[ModelConfig] = None, *, seed: int = 0
                 ) -> CompleteSegmentationModel:
    """Build the model on the CPU with weights drawn from `seed`."""
    config = config or ModelConfig()
    _check_supported(config)
    model = CompleteSegmentationModel(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (BatchNorm running stats are buffers)."""
    return sum(p.numel() for p in model.parameters())
