"""Shared building blocks, under the reference's torch module names.

Counterparts of lmsu_tpu/models/layers.py:
  InvertedResidual   reference camera_encoder.py:9-51   (`.conv` Sequential)
  Conv1x1Block       reference fusion_module.py:8-17    (`.conv` Sequential)
  DWSeparableConv    reference fusion_module.py:20-34   (`.net` Sequential)

The JAX package's ConvBNAct module is here `conv_bn_act`, which returns the
[conv, bn, act] layers that the reference flattens into its Sequentials, so
a reference state dict loads with strict=True.

Parameters stay float32; `apply_seq` runs a Sequential in the dtype of its
input (convolution weights are cast per call, BatchNorm takes low-precision
input with float32 statistics), which is how the JAX package runs bf16
compute over f32 parameters. BatchNorm: eps 1e-5, momentum 0.1 (flax 0.9).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lmsu_tpu_torch.ops.ir_fused import IRParams, fold_bn, fused_ir_infer


def conv_bn_act(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                groups: int = 1, act: Optional[nn.Module] = None) -> List[nn.Module]:
    """Conv2d (no bias, padding k//2) + BatchNorm2d (+ activation)."""
    layers: List[nn.Module] = [
        nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2,
                  groups=groups, bias=False),
        nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)]
    if act is not None:
        layers.append(act)
    return layers


def apply_seq(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Run `seq` in x's dtype: conv weights are cast to it per call."""
    for m in seq:
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            conv = F.conv1d if isinstance(m, nn.Conv1d) else F.conv2d
            bias = None if m.bias is None else m.bias.to(x.dtype)
            x = conv(x, m.weight.to(x.dtype), bias, m.stride, m.padding, m.dilation,
                     m.groups)
        else:
            x = m(x)
    return x


class InvertedResidual(nn.Module):
    """MobileNetV2 expand -> depthwise -> project; residual iff stride 1 and
    in_ch == out_ch. `.conv` indices (reference camera_encoder.py:19-44):
    expansion != 1: [0 pw, 1 bn, 2 relu6, 3 dw, 4 bn, 5 relu6, 6 pw, 7 bn];
    expansion == 1: [0 dw, 1 bn, 2 relu6, 3 pw, 4 bn].

    fused_inference: eval-mode calls run the block as one CUDA kernel
    (ops/ir_fused.py) with BN folded; the folded parameters are cached and
    refolded when any parameter or buffer changes in place."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 expansion_ratio: int = 6, fused_inference: bool = False):
        super().__init__()
        hidden = int(round(in_ch * expansion_ratio))
        self.stride = stride
        self.has_expand = expansion_ratio != 1
        self.use_residual = stride == 1 and in_ch == out_ch
        self.fused_inference = fused_inference
        layers: List[nn.Module] = []
        if self.has_expand:
            layers += conv_bn_act(in_ch, hidden, 1, act=nn.ReLU6())
        layers += conv_bn_act(hidden, hidden, 3, stride, groups=hidden, act=nn.ReLU6())
        layers += conv_bn_act(hidden, out_ch, 1)
        self.conv = nn.Sequential(*layers)
        self._folded: Tuple = (None, None)

    def folded_params(self, eps: float = 1e-5) -> IRParams:
        """BN-folded parameters in the JAX package's IRParams layout."""
        tensors = list(self.parameters()) + list(self.buffers())
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._folded[0] == key:
            return self._folded[1]
        c = list(self.conv)
        with torch.no_grad():
            def fold(bn):
                return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, eps)
            if self.has_expand:
                w1 = c[0].weight[:, :, 0, 0].t().contiguous()
                s1, b1 = fold(c[1])
                dwc, dwbn, pw, pwbn = c[3], c[4], c[6], c[7]
            else:
                w1 = s1 = b1 = None
                dwc, dwbn, pw, pwbn = c[0], c[1], c[3], c[4]
            dw = dwc.weight[:, 0].permute(1, 2, 0).contiguous()
            s2, b2 = fold(dwbn)
            w2 = pw.weight[:, :, 0, 0].t().contiguous()
            s3, b3 = fold(pwbn)
            params = IRParams(w1, s1, b1, dw, s2, b2, w2, s3, b3)
        self._folded = (key, params)
        return params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_inference and not self.training:
            y = fused_ir_infer(x.permute(0, 2, 3, 1), self.folded_params(),
                               stride=self.stride)
            return y.permute(0, 3, 1, 2)
        y = apply_seq(self.conv, x)
        return x + y if self.use_residual else y


class Conv1x1Block(nn.Module):
    """1x1 conv + BN + ReLU (reference fusion_module.py:8-17)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(*conv_bn_act(in_ch, out_ch, 1, act=nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_seq(self.conv, x)


class DWSeparableConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, BN + ReLU after each (reference
    fusion_module.py:20-34)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.net = nn.Sequential(
            *conv_bn_act(in_ch, in_ch, 3, stride, groups=in_ch, act=nn.ReLU()),
            *conv_bn_act(in_ch, out_ch, 1, act=nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_seq(self.net, x)
