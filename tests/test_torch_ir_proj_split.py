"""The projection kernels of the port's fused training path, K10 (forward)
and K11 (backward), on the CPU.

Both kernels form their 1x1 products on bf16 tensor cores through the
split-operand step of the fused path (csrc/ir_train_common.cuh::mma_step):
f32 operands are split into EXPAND_TERMS bf16 terms, the products a_i b_j
with i + j < EXPAND_TERMS of each 16-deep k-step are summed into a fresh
accumulator, and each k-step's sum is added to the running total; bf16
operands are one exact term. K11 sums dW2 over pixels per span of its
blocks and adds the spans' partials. `mma_matmul_emulated` (and
`proj_emulated` / `proj_bwd_emulated` around it) repeat that arithmetic in
plain PyTorch. Here:

- K10's y at depth Ce = 768 and K11's dd_hat = dy W2^T at depth Cout = 128
  are within 1e-6 of their scale of a float64 product, and one term fewer
  misses that;
- K11's dW2 = d_act^T dy, summed in registers over the spans the kernel
  takes at B=128 (4,000 / 2,016 / 1,504 pixels at stages 1 / 3 / 5), is
  within 1e-6 of scale of float64 (chip_smoke.py holds the kernel's own
  f32 dW2 to 1e-4 of scale of a float64 dW2 on the card);
- the emulation's ReLU6 mask is the plain version's, element for element,
  on inputs with v2 = d * s2 + b2 at exactly 0 and 6 (this checks the
  emulation only; chip_smoke.py runs the kernel on such inputs on the card
  and requires the plain version's zeros in dv2);
- the emulated K10 and K11 meet the plain versions within chip_smoke.py's
  f32 limits (1e-4 of scale).
"""

import numpy as np
import pytest
import torch

from lmsu_tpu_torch.ops import ir_fused as irf

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(707)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / max(1.0, ref.abs().max().item())).item()


def _bn2(rng, ce):
    return _t(rng.uniform(0.5, 1.5, ce)), _t(rng.normal(0, 0.2, ce))


def _span(m, groups):
    """csrc/ir_train_proj_bwd.cu::spans_of: pixels of one block's span."""
    want = max(1, 528 // groups)
    return -(-(-(-m // want)) // 32) * 32


@pytest.mark.parametrize("ce,cout", [(768, 128), (384, 64)])
def test_y_split_against_float64(rng, ce, cout):
    d = _t(rng.normal(0, 1, (512, ce)))
    s2, b2 = _bn2(rng, ce)
    w2 = _t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)))
    ref = irf._relu6(d * s2 + b2).double() @ w2.double()
    assert _rel(irf.proj_emulated(d, s2, b2, w2), ref) <= 1e-6
    assert _rel(irf.proj_emulated(d, s2, b2, w2, irf.EXPAND_TERMS - 1), ref) > 1e-6


@pytest.mark.parametrize("ce,cout", [(768, 128), (384, 64)])
def test_dd_hat_split_against_float64(rng, ce, cout):
    dy = _t(rng.normal(0, 1, (512, cout)))
    w2t = _t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout))).T.contiguous()
    ref = dy.double() @ w2t.double()
    assert _rel(irf.mma_matmul_emulated(dy, w2t, torch.float32), ref) <= 1e-6
    assert _rel(irf.mma_matmul_emulated(dy, w2t, torch.float32, irf.EXPAND_TERMS - 1), ref) > 1e-6


@pytest.mark.parametrize("ce,cout,m_b128,groups", [
    (32, 32, 128 * 128 * 128, 1), (384, 64, 128 * 64 * 64, 2), (768, 128, 128 * 32 * 32, 6)])
def test_dw2_long_sum_against_float64(rng, ce, cout, m_b128, groups):
    """Stages 1, 3 and 5 of the student (Ce, Cout, their pixels at B=128 and
    K11's channel groups there): two of the spans the kernel takes there and
    a ragged third, each summed over its span's k-steps, then added."""
    span = _span(m_b128, groups)
    assert span >= 1500
    m = 2 * span + 48
    d = _t(rng.normal(0, 1, (m, ce)))
    s2, b2 = _bn2(rng, ce)
    dy = _t(rng.normal(0, 1, (m, cout)))
    d_act = irf._relu6(d * s2 + b2)
    ref = d_act.double().T @ dy.double()
    got = irf.mma_matmul_emulated(d_act.T.contiguous(), dy, torch.float32, k_split=span)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_mask_is_the_plain_versions_at_ties(rng, dtype):
    """The emulation's mask against the plain version's (the kernel's own,
    on the card, is chip_smoke.py's check_proj_bwd_edges)."""
    m, ce, cout = 256, 64, 32
    d = _t(rng.normal(0, 2, (m, ce)))
    s2, b2 = _bn2(rng, ce)
    # Channels 0-7: v2 = d - d = 0 exactly; 8-15: v2 = 4 * 1 + 2 = 6; 16-23:
    # v2 = 12 * 0.5 + 0 = 6; the rest random.
    s2[:8], s2[8:16], s2[16:24] = 1.0, 1.0, 0.5
    d[:, 8:16], b2[8:16] = 4.0, 2.0
    d[:, 16:24], b2[16:24] = 12.0, 0.0
    d = d.to(dtype)
    b2[:8] = -d[0, :8].float()
    d[:, :8] = d[0, :8]
    v2 = d.float() * s2 + b2
    assert (v2[:, :8] == 0).all() and (v2[:, 8:24] == 6).all()
    dy = _t(rng.normal(0, 1, (m, cout))).to(dtype)
    m2, inv2 = d.float().mean(0), torch.rsqrt(d.float().var(0, unbiased=False) + 1e-5)
    w2 = _t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)))
    args = (d, dy, s2, b2, m2, inv2, w2)
    emu = irf.proj_bwd_emulated(*args, span=_span(m, 1))[0].float()
    plain = irf.proj_bwd_plain(*args)[0].float()
    assert (emu[:, :24] == 0).all() and (plain[:, :24] == 0).all()
    assert torch.equal(emu == 0, plain == 0)
    assert (emu[:, 24:] != 0).float().mean() > 0.3  # the random channels do pass


def test_emulated_kernels_meet_the_plain_versions(rng):
    m, ce, cout = 1024, 384, 64
    d = _t(rng.normal(0, 1, (m, ce)))
    s2, b2 = _bn2(rng, ce)
    w2 = _t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)))
    dy = _t(rng.normal(0, 1, (m, cout)))
    m2, inv2 = d.mean(0), torch.rsqrt(d.var(0, unbiased=False) + 1e-5)
    y, y_plain = irf.proj_emulated(d, s2, b2, w2), irf.proj_plain(d, s2, b2, w2)
    assert _rel(y, y_plain.double()) <= 1e-4
    args = (d, dy, s2, b2, m2, inv2, w2)
    for got, want in zip(irf.proj_bwd_emulated(*args, span=_span(m, 2)),
                         irf.proj_bwd_plain(*args)):
        assert got.shape == want.shape
        assert _rel(got, want.double()) <= 1e-4
