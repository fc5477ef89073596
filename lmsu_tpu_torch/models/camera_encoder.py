"""TwinLite-style lightweight camera encoder (NCHW inside the port).

Counterpart of lmsu_tpu/models/camera_encoder.py (reference:
camera_encoder.py:56-123): stem stride-2 conv + 5 InvertedResidual stages;
returns the final map or a multi-scale dict {stage2..stage5}.

CameraEncoderConfig.remat rematerialises each of the five
InvertedResidual stages in training (flax's nn.remat around the stage;
models/layers.py::remat): the stage's activations are recomputed in the
backward pass instead of kept, with fused_train too. Eval-mode calls and
calls without autograd run the stages as they are.

Shapes for a 256x256 input, base_channels=32:
  stem    [B,  32, 128, 128]
  stage1  [B,  32, 128, 128]   (expansion 1, stride 1)
  stage2  [B,  64,  64,  64]   (stride 2)
  stage3  [B,  64,  64,  64]
  stage4  [B, 128,  32,  32]   (stride 2)
  stage5  [B, 128,  32,  32]
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import CameraEncoderConfig
from lmsu_tpu_torch.models.layers import (InvertedResidual, ReLU6, apply_seq, conv_bn_act,
                                          remat)


class TwinLiteEncoder(nn.Module):
    """5-stage MobileNetV2-style encoder. Reference: camera_encoder.py:56."""

    def __init__(self, config: CameraEncoderConfig = CameraEncoderConfig()):
        super().__init__()
        self.config = config
        b1, b2, b4 = config.channels
        fused = (config.fused_inference, config.fused_train)
        self.stem = nn.Sequential(*conv_bn_act(config.in_channels, b1, 3, 2,
                                               act=ReLU6()))
        self.stage1 = InvertedResidual(b1, b1, 1, 1, *fused)
        self.stage2 = InvertedResidual(b1, b2, 2, 6, *fused)
        self.stage3 = InvertedResidual(b2, b2, 1, 6, *fused)
        self.stage4 = InvertedResidual(b2, b4, 2, 6, *fused)
        self.stage5 = InvertedResidual(b4, b4, 1, 6, *fused)

    @property
    def feature_channels(self) -> Dict[str, int]:
        _, b2, b4 = self.config.channels
        return {"stage2": b2, "stage3": b2, "stage4": b4, "stage5": b4}

    @property
    def out_channels(self) -> int:
        return self.config.channels[2]

    def forward(self, images: torch.Tensor
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.config.remat and self.training and torch.is_grad_enabled():
            def run(stage, x):
                return remat(stage, x)
        else:
            def run(stage, x):
                return stage(x)
        x = apply_seq(self.stem, images)
        x1 = run(self.stage1, x)
        x2 = run(self.stage2, x1)
        x3 = run(self.stage3, x2)
        x4 = run(self.stage4, x3)
        x5 = run(self.stage5, x4)
        if self.config.return_multiscale:
            return {"stage2": x2, "stage3": x3, "stage4": x4, "stage5": x5}
        return x5
