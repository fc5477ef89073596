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
compute over f32 parameters. BatchNorm: eps 1e-5, momentum 0.1 (flax 0.9),
with flax's running-variance rule (see `_FlaxRunningStats`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from lmsu_tpu_torch.ops.ir_fused import IRParams, fold_bn, fused_ir_infer, fused_ir_train


_REMAT = threading.local()


def recomputing() -> bool:
    """True while `remat` re-runs a forward for the backward pass."""
    return getattr(_REMAT, "on", False)


@contextlib.contextmanager
def _recomputing():
    prev, _REMAT.on = recomputing(), True
    try:
        yield
    finally:
        _REMAT.on = prev


def remat(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """fn(x) with its activations rematerialised (flax's nn.remat): the
    forward keeps only its input, and the backward pass runs fn again to
    rebuild what it needs (torch.utils.checkpoint, non-reentrant). The
    re-run happens inside `recomputing()`, under which the train-mode
    BatchNorms of this module and the fused blocks leave their running
    statistics alone, so they move once a step, as flax's do. No stage draws
    random numbers, so the RNG state is not saved."""
    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class _FlaxRunningStats:
    """Train-mode BatchNorm with flax's semantics (flax 0.12
    `BatchNorm.__call__` / `_compute_stats`).

    Normalisation uses the biased batch statistics, reduced in float32 for
    bf16 input (flax's `force_float32_reductions`), and the output is in the
    input dtype. The running averages take the BIASED batch variance:
    `var = 0.9 var + 0.1 var_batch` (torch's own BatchNorm would take the
    unbiased one). flax reduces the variance as E[x^2] - E[x]^2; torch's
    kernels reduce it in a numerically stabler form, which differs from it
    by float32 rounding only. Eval mode is torch's (running statistics).
    State-dict names are torch's: weight, bias, running_mean, running_var,
    num_batches_tracked.

    The statistics come from one `F.batch_norm` call, which reads the input
    once and updates the running buffers with the unbiased variance
    var_b * n / (n - 1); the running variance is then taken back to the
    biased rule by scaling its new share by (n - 1) / n. The call updates a
    copy of the running variance: autograd saves the buffers it was given,
    so they must not change again before the backward. Under `remat`'s
    re-run the same call takes copies of both running buffers, so the
    output and what autograd saves are the first run's and the buffers
    move once.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if recomputing():
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            kept = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.num_batches_tracked.add_(1)
        return y


class ReLU6(nn.ReLU6):
    """ReLU6 with the JAX package's gradient: its relu6 is
    min(max(x, 0), 6), whose derivative at exactly 0 and 6 is 1/2 (a tie
    splits the gradient, in torch.maximum/minimum as in jnp's); torch's
    ReLU6 gives 0 there. The forward is the same. It matters in training: a
    channel whose batch variance is 0 leaves its BatchNorm output exactly at
    the bias, 0 at init, at every position.

    The forward is torch's one-kernel hardtanh; the backward writes that
    derivative as (sign(x) + sign(6 - x)) / 2, fewer passes over the
    activation than autograd of min(max(...)) makes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ReLU6Fn.apply(x)


class _ReLU6Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.hardtanh(x, 0.0, 6.0)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (torch.sign(x) + torch.sign(6.0 - x)) * 0.5


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    """BatchNorm over [B, C, N] with flax's train-mode statistics."""


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    """BatchNorm over [B, C, H, W] with flax's train-mode statistics."""


def conv_bn_act(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                groups: int = 1, act: Optional[nn.Module] = None) -> List[nn.Module]:
    """Conv2d (no bias, padding k//2) + BatchNorm2d (+ activation)."""
    layers: List[nn.Module] = [
        nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2,
                  groups=groups, bias=False),
        BatchNorm2d(cout, eps=1e-5, momentum=0.1)]
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
        elif isinstance(m, nn.ConvTranspose2d):
            bias = None if m.bias is None else m.bias.to(x.dtype)
            x = F.conv_transpose2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding,
                                   m.output_padding, m.groups, m.dilation)
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
    refolded when any parameter or buffer changes in place.

    fused_train: train-mode calls run `fused_ir_train` (kernels K8-K13) on
    views of this module's own parameters, so gradients reach the conv and
    BN parameters and checkpoints are unchanged; the BN running statistics
    are updated from the block's batch statistics as the JAX package's
    `_fused_train_call` does (layers.py:120-158)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 expansion_ratio: int = 6, fused_inference: bool = False,
                 fused_train: bool = False):
        super().__init__()
        hidden = int(round(in_ch * expansion_ratio))
        self.stride = stride
        self.has_expand = expansion_ratio != 1
        self.use_residual = stride == 1 and in_ch == out_ch
        self.fused_inference = fused_inference
        self.fused_train = fused_train
        self.widths = (in_ch, out_ch)
        layers: List[nn.Module] = []
        if self.has_expand:
            layers += conv_bn_act(in_ch, hidden, 1, act=ReLU6())
        layers += conv_bn_act(hidden, hidden, 3, stride, groups=hidden, act=ReLU6())
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

    def _fused_train_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = list(self.conv)
        if self.has_expand:
            pw1, bn1, dwc, bn2, pw2, bn3 = c[0], c[1], c[3], c[4], c[6], c[7]
            w1, g1, be1 = pw1.weight[:, :, 0, 0].t(), bn1.weight, bn1.bias
        else:
            dwc, bn2, pw2, bn3 = c[0], c[1], c[3], c[4]
            ce = dwc.weight.shape[0]
            w1 = x.new_zeros(x.shape[1], ce, dtype=torch.float32)
            g1 = be1 = x.new_zeros(ce, dtype=torch.float32)
        out, (m1, v1, m2, v2, m3, v3) = fused_ir_train(
            x.permute(0, 2, 3, 1), w1, g1, be1, dwc.weight[:, 0].permute(1, 2, 0),
            bn2.weight, bn2.bias, pw2.weight[:, :, 0, 0].t(), bn3.weight, bn3.bias,
            self.stride, self.has_expand, bn3.eps)
        if recomputing():  # remat's re-run: the statistics moved in the first run
            return out.permute(0, 3, 1, 2)
        with torch.no_grad():
            stats = ((bn1, m1, v1),) if self.has_expand else ()
            for bn, m, v in stats + ((bn2, m2, v2), (bn3, m3, v3)):
                mom = bn.momentum  # torch 0.1 == flax 0.9
                bn.running_mean.copy_((1.0 - mom) * bn.running_mean + mom * m)
                bn.running_var.copy_((1.0 - mom) * bn.running_var + mom * v)
                bn.num_batches_tracked.add_(1)
        return out.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_inference and not self.training:
            y = fused_ir_infer(x.permute(0, 2, 3, 1), self.folded_params(),
                               stride=self.stride)
            return y.permute(0, 3, 1, 2)
        if self.fused_train and self.training:
            return self._fused_train_forward(x)
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
