"""Shared building blocks, under the reference's torch module names.

Counterparts of lmsu_tpu/models/layers.py:
  InvertedResidual   reference camera_encoder.py:9-51   (`.conv` Sequential)
  Conv1x1Block       reference fusion_module.py:8-17    (`.conv` Sequential)
  DWSeparableConv    reference fusion_module.py:20-34   (`.net` Sequential)

The JAX package's ConvBNAct module is here `conv_bn_act`, which returns the
[conv, bn, act] layers that the reference flattens into its Sequentials, so
a reference state dict loads with strict=True.

Int8 (w8a8) serving, as the JAX package's ConvBNAct (layers.py:38-98): an
eligible layer is a 1x1, groups=1 Conv2d followed by its BatchNorm2d in
eval mode (`quant_eligible`). `apply_seq` runs it

  * inside `calibration()`: the normal path, plus a running max of |input|
    kept on the conv as `act_absmax` (a plain attribute, outside the state
    dict, so a reference state dict still loads strictly);
  * with `act_absmax` set, outside calibration: BN folded into the kernel
    and the int8 product of ops/quant.py, then the activation;
  * otherwise, and in every training path: the normal path.

The fused InvertedResidual blocks (fused_inference) run K3 and reach none
of their convs, as in the JAX package.

Parameters stay float32; `apply_seq` runs a Sequential in the dtype of its
input (convolution weights are cast per call, BatchNorm takes low-precision
input with float32 statistics), which is how the JAX package runs bf16
compute over f32 parameters. BatchNorm: eps 1e-5, momentum 0.1 (flax 0.9),
with flax's running-variance rule (see `_FlaxRunningStats`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from lmsu_tpu_torch.ops.ir_fused import IRParams, fold_bn, fused_ir_infer, fused_ir_train
from lmsu_tpu_torch.ops.quant import int8_pointwise
from lmsu_tpu_torch.parallel.mesh import all_reduce_, data_mesh


_REMAT = threading.local()
_CALIBRATING = threading.local()


def calibrating() -> bool:
    """True inside `calibration()`."""
    return getattr(_CALIBRATING, "on", False)


@contextlib.contextmanager
def calibration():
    """Within it, eval forwards record each int8-eligible conv's running
    absmax of its input (`act_absmax`) and run the float path."""
    prev, _CALIBRATING.on = calibrating(), True
    try:
        yield
    finally:
        _CALIBRATING.on = prev


def quant_eligible(conv: nn.Module, nxt: Optional[nn.Module]) -> bool:
    """The JAX package's int8 eligibility (ConvBNAct.__call__'s quant_ok): a
    1x1, groups=1 conv (stride 1) whose BatchNorm follows it, in eval."""
    return (isinstance(conv, nn.Conv2d) and conv.kernel_size == (1, 1) and conv.groups == 1
            and conv.stride == (1, 1) and isinstance(nxt, nn.BatchNorm2d) and not nxt.training)


def quant_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The calibrated absmax of each int8 layer, by its conv's module name."""
    return {n: m.act_absmax for n, m in model.named_modules()
            if getattr(m, "act_absmax", None) is not None}


def set_quant_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    """Clear every conv's calibrated absmax, then set `stats` (by module name,
    as quant_stats gives them); an unknown name raises KeyError."""
    mods = dict(model.named_modules())
    unknown = sorted(set(stats) - {n for n, m in mods.items() if isinstance(m, nn.Conv2d)})
    if unknown:
        raise KeyError(f"no conv named {unknown}")
    dev = next(model.parameters()).device
    for m in mods.values():
        if isinstance(m, nn.Conv2d):
            m.act_absmax = None
    for name, v in stats.items():
        mods[name].act_absmax = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())


def _int8_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """conv + BN on NCHW x through ops/quant.py::int8_pointwise, BN folded
    into the kernel as the JAX package's ConvBNAct._int8_call does."""
    w, bias = fold_conv_bn(conv, bn)
    y = int8_pointwise(x.permute(0, 2, 3, 1), conv.act_absmax, w[:, :, 0, 0].t(), bias, x.dtype)
    return y.permute(0, 3, 1, 2)


def fold_conv_bn(conv: nn.Module, bn: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval BN folded into the conv before it: (weight, bias) in f32,
    the weight in the conv's own layout, scaled per output channel (dim 0,
    or dim 1 of a transposed conv's [I, O, kh, kw]); the bias is the BN's
    folded bias plus the conv's bias times the scale."""
    with torch.no_grad():
        scale, bias = fold_bn(bn.weight.float(), bn.bias.float(), bn.running_mean.float(),
                              bn.running_var.float(), bn.eps)
        if conv.bias is not None:
            bias = bias + conv.bias.float() * scale
        dim = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
        shape = [1] * conv.weight.dim()
        shape[dim] = -1
        return conv.weight.float() * scale.reshape(shape), bias


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

    Under data parallelism (a mesh of more than one rank, parallel/mesh.py)
    the statistics are the global batch's, as GSPMD makes flax's
    (`_SyncedBatchNorm`). The running variance takes the biased batch
    variance; the remat re-run reduces again and leaves the buffers alone.
    torch's SyncBatchNorm cannot stand in: it refuses CPU tensors and keeps
    the unbiased running variance.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if data_mesh() is not None:
            return self._synced(x)
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

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over the global batch of the data mesh."""
        y, mean, var = _SyncedBatchNorm.apply(x, self.weight, self.bias, self.eps, data_mesh())
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return y


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a data mesh.

    Forward: each rank sums x and x^2 over its rows, one all-reduce sums
    them and the row counts over ranks, and the mean and flax's fast
    variance max(E[x^2] - E[x]^2, 0) normalise x as flax's `_normalize`
    does, in f32, output in x's dtype. The sums accumulate, are reduced and
    are finalised in float64 (x^2 formed in f32), then mean and variance
    are f32: f32 sums split over ranks move the statistics by ~1e-7 a layer,
    ~1e-6 through the network, enough to flip a ReLU at a pre-activation of
    -2e-6 in the KD step of tests/test_torch_parallel_kd.py (with
    fused_train) and take the step out of the JAX reference's spread.

    Backward: BatchNorm's own derivative, dx = g inv (dy - mean(dy) - xhat
    mean(dy xhat)), with the two means over the global batch (one
    all-reduce of sum(dy), sum(dy xhat)); differentiating the fast variance
    instead would form 2 x dL/dsq + dL/ds in f32, which cancels where a
    channel's mean is large against its spread. The weight and bias
    gradients are this rank's sums (as torch's SyncBatchNorm returns them):
    the trainer's gradient all-reduce sums them once."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        f64 = torch.float64
        tot = all_reduce_(torch.cat([xf.sum(dims, dtype=f64), (xf * xf).sum(dims, dtype=f64),
                                     xf.new_full((1,), float(x.numel() // c), dtype=f64)]),
                          mesh=mesh)
        n = tot[2 * c]
        mean64 = tot[:c] / n
        mean = mean64.float()
        var = torch.clamp(tot[c:2 * c] / n - mean64 * mean64, min=0.0).float()
        shape = [1, c] + [1] * (x.dim() - 2)
        inv = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (inv * weight.float()).view(shape) + bias.float().view(shape)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.n, ctx.mesh = float(n), mesh
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _g_mean, _g_var):
        x, weight, mean, inv = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        gyf = gy.float()
        xhat = (x.float() - mean.view(shape)) * inv.view(shape)
        local = torch.cat([gyf.sum(dims, dtype=torch.float64),
                           (gyf * xhat).sum(dims, dtype=torch.float64)])
        tot = all_reduce_(local.clone(), mesh=ctx.mesh) / ctx.n
        mdy, mdyx = (t.float().view(shape) for t in tot.split(c))
        dx = (gyf - mdy - xhat * mdyx) * (inv * weight.float()).view(shape)
        db, dw = (t.to(weight.dtype) for t in local.split(c))
        return dx.to(x.dtype), dw, db, None, None


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
    """Run `seq` in x's dtype: conv weights are cast to it per call. An
    int8-eligible conv + BN is calibrated or quantised as the module
    docstring says."""
    mods = list(seq)
    skip = False
    for i, m in enumerate(mods):
        if skip:  # the BN of a quantised conv
            skip = False
            continue
        if quant_eligible(m, mods[i + 1] if i + 1 < len(mods) else None):
            if calibrating():
                seen = x.abs().amax().float()
                prev = getattr(m, "act_absmax", None)
                m.act_absmax = seen if prev is None else torch.maximum(prev, seen)
            elif getattr(m, "act_absmax", None) is not None:
                x = _int8_conv_bn(m, mods[i + 1], x)
                skip = True
                continue
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
    refolded when any parameter or buffer changes in place. A frozen copy
    (models/frozen.py) holds them in `frozen` instead, folded once.

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
        self.frozen: Optional[nn.Module] = None  # models/frozen.py::FrozenIRParams

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
            p = self.folded_params() if self.frozen is None else self.frozen.params()
            y = fused_ir_infer(x.permute(0, 2, 3, 1), p, stride=self.stride)
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
