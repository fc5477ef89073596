"""Frozen serving copies of a model: the counterpart of the JAX package's
Predictor(freeze_weights=True) (lmsu_tpu/inference.py:26-58).

JAX closes the variables into the jitted forward as constants, so XLA folds
the eval BatchNorms into the convolutions and the engine refuses a weight
swap. `freeze_model` does that fold once, on a deep copy:

  * each conv + BatchNorm pair of a Sequential (Conv1d, Conv2d or
    ConvTranspose2d, then its BatchNorm) becomes the conv with the BN
    folded into its weight and bias (models/layers.py::fold_conv_bn); the
    BatchNorm becomes nn.Identity;
  * a conv calibrated for int8 (its `act_absmax` set, models/layers.py)
    becomes `Int8Conv`: the BN folded and the weights quantised once, the
    activations quantised per call with the calibrated absmax;
  * each fused InvertedResidual (fused_inference) holds its folded IRParams
    in `FrozenIRParams`, folded once, instead of its cache keyed by storage
    (which an exporting trace, whose tensors have no storage, cannot read).

The copy serves eval forwards only (its BatchNorms are gone) and is what
Predictor.export traces, with the weights as constants of the graph.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from lmsu_tpu_torch.models.layers import InvertedResidual, fold_conv_bn, quant_eligible
from lmsu_tpu_torch.ops.ir_fused import IRParams
from lmsu_tpu_torch.ops.quant import int8_pointwise_q, quantize_weights

_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)
_BNS = (nn.BatchNorm1d, nn.BatchNorm2d)


class Int8Conv(nn.Module):
    """A calibrated 1x1 conv + BN, frozen: weights folded and quantised at
    construction (ops/quant.py::quantize_weights), NCHW in, NCHW out in the
    input's dtype, through ops/quant.py::int8_pointwise_q."""

    def __init__(self, conv: nn.Conv2d, bn: nn.BatchNorm2d):
        super().__init__()
        w, bias = fold_conv_bn(conv, bn)
        wq, w_scale = quantize_weights(w[:, :, 0, 0].t())
        self.register_buffer("wq_t", wq.t().contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("act_absmax", conv.act_absmax.detach().float().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_pointwise_q(x.permute(0, 2, 3, 1), self.act_absmax, self.wq_t, self.w_scale,
                             self.bias, x.dtype)
        return y.permute(0, 3, 1, 2)


class FrozenIRParams(nn.Module):
    """A fused block's folded IRParams as buffers (w1, s1, b1 None at
    expansion 1), so they move with the module and export as constants."""

    def __init__(self, p: IRParams):
        super().__init__()
        for name, t in p._asdict().items():
            self.register_buffer(name, None if t is None else t.detach().clone())

    def params(self) -> IRParams:
        return IRParams(*(getattr(self, f) for f in IRParams._fields))


def freeze_model(model: nn.Module) -> nn.Module:
    """An eval-only copy of `model` with every BatchNorm folded away, the
    calibrated convs quantised and the fused blocks' parameters folded once
    (the module docstring). `model` itself is not changed."""
    frozen = copy.deepcopy(model).eval()
    with torch.no_grad():
        for m in frozen.modules():
            if isinstance(m, InvertedResidual):
                if m.fused_inference:
                    m.frozen = FrozenIRParams(m.folded_params())
                m._folded = (None, None)
        for seq in [m for m in frozen.modules() if isinstance(m, nn.Sequential)]:
            for i in range(len(seq) - 1):
                conv, bn = seq[i], seq[i + 1]
                if not (isinstance(conv, _CONVS) and isinstance(bn, _BNS)):
                    continue
                if quant_eligible(conv, bn) and getattr(conv, "act_absmax", None) is not None:
                    seq[i] = Int8Conv(conv, bn)
                else:
                    w, bias = fold_conv_bn(conv, bn)
                    conv.weight.copy_(w)
                    conv.bias = nn.Parameter(bias)
                seq[i + 1] = nn.Identity()
    left = [n for n, m in frozen.named_modules() if isinstance(m, _BNS)]
    if left:
        raise ValueError(f"freeze_model: BatchNorms not after a conv: {left}")
    for p in frozen.parameters():
        p.requires_grad_(False)
    return frozen
