"""Post-training int8 (w8a8) quantisation of the 1x1 convolutions, for
serving. Counterpart of lmsu_tpu/ops/quant.py (:46-84), with the same scheme:

  * eligible layers: the 1x1, groups=1 convolutions followed by a BatchNorm
    (models/layers.py::apply_seq); depthwise and 3x3 convolutions, the
    LiDAR point MLP, the gate and the classifier stay at the compute dtype;
  * weights: the BatchNorm folded into the kernel first (ops/ir_fused.py::
    fold_bn, eps 1e-5), then per-output-channel symmetric scales
    s_w = max|w| / 127, floored at 1e-12;
  * activations: a per-tensor scale s_x = absmax / 127 from the absmax a
    calibration pass recorded (inference.py::calibrate_quant);
  * round half to even (torch.round and jnp.round alike), clip to +-127, an
    s8 x s8 -> s32 product, then dequantise and add the bias in f32 and
    cast to the compute dtype.

The JAX package leaves the int8 product to XLA (`lax.dot_general` with an
int32 result), outside any Pallas kernel; here it is `torch._int_mm` on the
card (cuBLASLt's int8 GEMM) and an exact int32 product on the CPU.
`torch._int_mm` takes M > 16 rows and K, N multiples of 8: `int8_matmul`
pads with zero rows and columns where a layer needs it, which leaves an
integer product exact. `int8_matmul_plain` is the exact product on any
device (int32 on the CPU, float64 of the int8 values on the card, exact
below 2^53), which the tests and chip_smoke.py hold the card's to.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_QMAX = 127.0


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantisation of a [Cin, Cout]
    (BN-folded) kernel. Returns (w_int8 [Cin, Cout], scales f32 [Cout])."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=0) / _QMAX, min=1e-12)  # zero columns give zeros
    wq = torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8)
    return wq, s


def quantize_acts(x: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation with a calibrated absmax.
    Returns (x_int8, scale f32 scalar)."""
    s = torch.clamp(absmax.float(), min=1e-12) / _QMAX
    xq = torch.clamp(torch.round(x.float() / s), -_QMAX, _QMAX).to(torch.int8)
    return xq, s


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product xq [M, K] @ wq [K, N] of int8 operands: int32
    arithmetic on the CPU; on the card a float64 product of the int8 values
    (every partial sum an integer below 2^53), cast to int32."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    return (xq.double() @ wq.double()).to(torch.int32)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - t.shape[0], cols - t.shape[1]
    return t if pr == 0 and pc == 0 else F.pad(t, (0, pc, 0, pr))


def int8_mm_padded(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """torch._int_mm of xq [M, K] and wq_t [N, K] (the weight stored by
    output channel, handed to cuBLASLt column-major): M padded to at least
    17 rows and K, N to multiples of 8 with zeros, the padding sliced off
    the int32 result [M, N]."""
    M, K = xq.shape
    N = wq_t.shape[0]
    k8, n8 = -(-K // 8) * 8, -(-N // 8) * 8
    a = _pad_to(xq, max(M, 17), k8).contiguous()
    b = _pad_to(wq_t, n8, k8).contiguous()
    y = torch._int_mm(a, b.t())
    return y if y.shape == (M, N) else y[:M, :N]


def int8_matmul(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> s32 product xq [M, K] @ wq_t.T: torch._int_mm on the card
    (int8_mm_padded), the exact plain product for CPU tensors."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq_t.t())
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CPU or CUDA, not {xq.device}")
    return int8_mm_padded(xq, wq_t)


def int8_pointwise_q(x: torch.Tensor, act_absmax: torch.Tensor, wq_t: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor, out_dtype) -> torch.Tensor:
    """Quantised 1x1 conv on channels-last rows x [..., Cin] with weights
    already quantised: wq_t [Cout, Cin] int8, w_scale [Cout] f32, bias
    [Cout] (the folded BN's). Returns [..., Cout] in out_dtype."""
    lead, cin = x.shape[:-1], x.shape[-1]
    xq, s_x = quantize_acts(x.reshape(-1, cin), act_absmax)
    y = int8_matmul(xq, wq_t)
    out = (y.float() * (s_x * w_scale) + bias.float()).to(out_dtype)
    return out.reshape(*lead, wq_t.shape[0])


def int8_pointwise(x: torch.Tensor, act_absmax: torch.Tensor, w_folded: torch.Tensor,
                   bias: torch.Tensor, out_dtype) -> torch.Tensor:
    """Quantised 1x1 conv: x [..., Cin] @ w_folded [Cin, Cout] + bias, the
    weights quantised in the call as the JAX package's int8_pointwise does."""
    wq, s_w = quantize_weights(w_folded)
    return int8_pointwise_q(x, act_absmax, wq.t().contiguous(), s_w, bias, out_dtype)
