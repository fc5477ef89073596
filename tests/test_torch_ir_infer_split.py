"""K3's arithmetic (the fused InvertedResidual inference kernel,
csrc/ir_fused_infer.cu) on the CPU.

K3 forms both 1x1 products on bf16 tensor cores through the fused path's
split-operand step (ir_train_common.cuh::mma_step: f32 operands in
EXPAND_TERMS bf16 terms, a fresh accumulator a 16-deep k-step; bf16 one
exact product), with the TPU inference kernel's rounding points, which are
not the training path's: e = x . W1 is NOT rounded before BN1, relu6(e *
s1 + b1) is; d is rounded before the projection; the BN3 result is rounded
and the residual added in the input dtype. `fused_ir_infer_emulated`
repeats that arithmetic in plain PyTorch. Here, at narrow widths that are
multiples of 4 but not of 16 (the kernel pads K and N with zero
fragments), with and without the expand, at stride 1 and 2, with a
residual:

- in f32 the emulation is within 1e-6 of its scale (max(1, max |ref|)) of
  a float64 block, and one term fewer misses that;
- it meets the JAX package's fused_ir_infer (Pallas in interpret mode,
  matmul precision "highest") within 1e-5 of scale in f32, and within 2e-2
  of scale in bf16 (chip_smoke.py's bf16 limit for K3: one bf16 rounding of
  an intermediate may land on the other side);
- on a block built so that e * s1 + b1 rounds differently in bf16 when e is
  rounded first, the emulation and the plain version give the JAX kernel's
  value exactly, which the training path's rounding (`_expand_act`) does
  not (chip_smoke.py runs the kernel on the same block on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lmsu_tpu.ops.ir_fused import IRParams as JaxIRParams
from lmsu_tpu.ops.ir_fused import fused_ir_infer as jax_fused_ir_infer
from lmsu_tpu_torch.ops import ir_fused as irf

torch.set_num_threads(2)

VARIANTS = [  # (Cin, Cout, stride, expansion, H)
    (12, 12, 1, 6, 8),   # residual, Ce 72
    (4, 20, 2, 6, 8),    # stride 2, Ce 24
    (20, 20, 1, 1, 8),   # expansion 1, residual
]
F32_VS_FLOAT64 = 1e-6
F32_VS_JAX = 1e-5
BF16_VS_JAX = 2e-2


def _params(rng, cin, cout, exp):
    ce = cin * exp
    sb = lambda c: (rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c))  # noqa: E731
    s1, b1 = sb(ce)
    s2, b2 = sb(ce)
    s3, b3 = sb(cout)
    w1 = rng.normal(0, np.sqrt(2.0 / cin), (cin, ce)) if exp != 1 else None
    p = (w1, s1 if w1 is not None else None, b1 if w1 is not None else None,
         rng.normal(0, np.sqrt(2.0 / 9), (3, 3, ce)), s2, b2,
         rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)), s3, b3)
    return [None if a is None else np.asarray(a, np.float32) for a in p]


def _torch(p, dtype=torch.float32):
    return irf.IRParams(*(None if a is None else torch.from_numpy(a).to(dtype) for a in p))


def _jax(x, p, stride, dtype):
    jp = JaxIRParams(*(None if a is None else jnp.asarray(a) for a in p))
    with jax.default_matmul_precision("highest"):
        out = jax_fused_ir_infer(jnp.asarray(x, dtype), jp, stride=stride)
    return np.asarray(out.astype(jnp.float32))


def _float64_block(x, p, stride):
    d64 = lambda a: torch.from_numpy(a).double()  # noqa: E731
    w1, s1, b1, dw, s2, b2, w2, s3, b3 = p
    xt = d64(x)
    e = irf._relu6(xt @ d64(w1) * d64(s1) + d64(b1)) if w1 is not None else xt
    ce = e.shape[-1]
    d = F.conv2d(e.permute(0, 3, 1, 2), d64(dw).permute(2, 0, 1).unsqueeze(1), stride=stride,
                 padding=1, groups=ce).permute(0, 2, 3, 1)
    d = irf._relu6(d * d64(s2) + d64(b2))
    out = d @ d64(w2) * d64(s3) + d64(b3)
    return out + xt if stride == 1 and x.shape[-1] == w2.shape[-1] else out


def _scaled_err(got, ref):
    ref = torch.as_tensor(np.array(ref)).double()
    return ((got.double() - ref).abs().max() / max(1.0, ref.abs().max().item())).item()


@pytest.fixture
def rng():
    return np.random.default_rng(903)


def _inputs(rng, variant):
    cin, cout, stride, exp, H = variant
    x = rng.uniform(0, 3, (2, H, H, cin)).astype(np.float32)
    return x, _params(rng, cin, cout, exp), stride


@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_against_float64(rng, variant):
    x, p, stride = _inputs(rng, variant)
    ref = _float64_block(x, p, stride)
    got = irf.fused_ir_infer_emulated(torch.from_numpy(x), _torch(p), stride)
    assert _scaled_err(got, ref) <= F32_VS_FLOAT64
    fewer = irf.fused_ir_infer_emulated(torch.from_numpy(x), _torch(p), stride,
                                        irf.EXPAND_TERMS - 1)
    assert _scaled_err(fewer, ref) > F32_VS_FLOAT64


@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_against_jax_kernel(rng, variant):
    x, p, stride = _inputs(rng, variant)
    got = irf.fused_ir_infer_emulated(torch.from_numpy(x), _torch(p), stride)
    assert got.shape == irf.fused_ir_infer_plain(torch.from_numpy(x), _torch(p), stride).shape
    assert _scaled_err(got, _jax(x, p, stride, jnp.float32)) <= F32_VS_JAX


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_against_jax_kernel(rng, variant):
    x, p, stride = _inputs(rng, variant)
    xb = torch.from_numpy(x).bfloat16()
    got = irf.fused_ir_infer_emulated(xb, _torch(p), stride)
    assert got.dtype == torch.bfloat16
    want = _jax(np.asarray(xb.float()), p, stride, jnp.bfloat16)
    assert _scaled_err(got.float(), want) <= BF16_VS_JAX


def test_e_is_not_rounded_before_bn1():
    xt, pt = irf.infer_rounding_probe()  # chip_smoke.py runs K3 on this block
    x, p = xt.numpy(), [a.numpy() for a in pt]
    xb = xt.bfloat16()
    want = _jax(x, p, 1, jnp.bfloat16)
    assert (want[..., 0] == 3 + 2.0 ** -6).all()
    for fn in (irf.fused_ir_infer_emulated, irf.fused_ir_infer_plain):
        got = fn(xb, _torch(p), 1).float().numpy()
        np.testing.assert_array_equal(got, want)
    # The training path's rounding (e rounded before BN1) gives another value.
    e_act = irf._expand_act(xb, _torch(p).w1, _torch(p).s1, _torch(p).b1)[2]
    assert (e_act[..., 0] == 3.0).all()


def test_fragments_built_once_per_weight_also_under_inference_mode():
    """K3's W1/W2 fragments are built once per folded weight and rebuilt
    when it changes in place; a weight folded under torch.inference_mode
    (as the Predictor folds), which has no version counter, is cached too."""
    w = torch.randn(12, 72)
    f1, k1 = irf._infer_fragments(w, torch.float32)
    assert irf._infer_fragments(w, torch.float32)[0] is f1 and k1 == f1.shape[1]
    w.mul_(2.0)
    f2, _ = irf._infer_fragments(w, torch.float32)
    assert f2 is not f1
    assert torch.equal(f2, irf.mma_fragments(w, torch.float32))
    with torch.inference_mode():
        wi = torch.randn(12, 72)
        g1, _ = irf._infer_fragments(wi, torch.bfloat16)
        assert irf._infer_fragments(wi, torch.bfloat16)[0] is g1
        assert torch.equal(g1, irf.mma_fragments(wi.to(torch.bfloat16).float(), torch.bfloat16))
