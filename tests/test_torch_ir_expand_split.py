"""The shared expand of the port's fused training kernels K8, K9, K12 and K13,
on the CPU.

The kernels compute e = x . W1 on bf16 tensor cores through one device
function (csrc/ir_train_common.cuh::expand_step): f32 operands are split
into EXPAND_TERMS bf16 terms, each the bf16 rounding of what the earlier
terms left (ops/kd_loss.py::split_bf16), the products x_i W_j with i + j <
EXPAND_TERMS of each 16-channel k-step are summed into a fresh accumulator,
and each k-step's sum is added to the running total; bf16 operands are one
exact term. Here:

- `expand_e_emulated` (that arithmetic in plain PyTorch) meets the JAX
  kernels' own e (`_expand_chunk`, Pallas's expand at "highest" matmul
  precision) in f32 within 1e-6 of e's scale, and in bf16 within one bf16
  step (2^-8) of the scale: both sides round the f32 sum to bf16, and a sum
  that lands within f32 rounding of a bf16 boundary may round either way;
- EXPAND_TERMS is the fewest terms that hold the f32 limit at the student's
  widths (Cin 32 -> Ce 192 and Cin 128 -> Ce 768) against a float64
  product: one fewer misses it;
- `mma_fragments` puts each W1 value where the kernels' B fragments read
  it, and `mma_products` counts the products the kernels issue;
- K13's dW1 (`expand_bwd_plain`, and the emulated e feeding de) holds the
  f32 limit chip_smoke.py sets on the card, 1e-4 of scale, against a
  float64 reference at the 128^2 32 -> 64 stage's widths (Cin 32, Ce 192);
- K8 forms BN1's sums from the same e (since it calls expand_step too):
  the sums of the emulated e meet JAX's `_stats1_kernel` (Pallas, interpret
  mode) within the limits chip_smoke.py holds K8 to on the card.
"""

import functools


import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lmsu_tpu.ops.ir_fused import _COMPILER_PARAMS, _bspec, _expand_chunk, _stats1_kernel, _vspec
from lmsu_tpu_torch.ops import ir_fused as irf

torch.set_num_threads(2)

WIDTHS = [(32, 192), (128, 768)]  # the student's stage 2 and stage 5 expands


@pytest.fixture
def rng():
    return np.random.default_rng(606)


def _inputs(rng, cin, ce, n=8):
    x = rng.uniform(0, 3, (n, n, cin)).astype(np.float32)  # a ReLU6 output
    w1 = rng.normal(0, np.sqrt(2.0 / cin), (cin, ce)).astype(np.float32)
    return x, w1


def _jax_e(x, w1, jdt):
    """JAX's fused-path e, from the function its Pallas kernels call."""
    ce = w1.shape[1]
    xj = jnp.asarray(x, jdt)
    with jax.default_matmul_precision("highest"):
        e32, _, _ = _expand_chunk(xj, jnp.asarray(w1, jdt), jnp.zeros((1, ce), jnp.float32),
                                  jnp.zeros((1, ce), jnp.float32), x.shape[0], x.shape[1])
    return np.asarray(e32).reshape(x.shape[0], x.shape[1], ce)


@pytest.mark.parametrize("cin,ce", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulation_equals_jax_e(rng, cin, ce, dtype):
    x, w1 = _inputs(rng, cin, ce)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    want = _jax_e(x, w1, jdt)
    xt = torch.from_numpy(x).to(tdt)
    got = irf.expand_e_emulated(xt, torch.from_numpy(w1))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.to(tdt).float(), got)  # rounded to the input dtype
    scale = np.abs(want).max()
    tol = 1e-6 if dtype == "f32" else 2.0 ** -8
    assert np.abs(got.numpy() - want).max() <= tol * scale


@pytest.mark.parametrize("cin,ce", WIDTHS)
def test_expand_terms_are_the_fewest_that_hold_the_limit(rng, cin, ce):
    x, w1 = _inputs(rng, cin, ce)
    ref = torch.from_numpy(x).double().reshape(-1, cin) @ torch.from_numpy(w1).double()

    def rel(terms):
        got = irf.expand_e_emulated(torch.from_numpy(x), torch.from_numpy(w1), terms)
        return ((got.reshape(-1, ce).double() - ref).abs().max() / ref.abs().max()).item()

    assert rel(irf.EXPAND_TERMS) <= 2.5e-7
    assert rel(irf.EXPAND_TERMS - 1) > 1e-6


def test_mma_products():
    assert irf.mma_products(torch.bfloat16) == 1
    assert irf.mma_products(torch.float32) == irf.EXPAND_TERMS * (irf.EXPAND_TERMS + 1) // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mma_fragments_layout(rng, dtype):
    k, n = 40, 72
    w = torch.from_numpy(rng.normal(0, 1, (k, n)).astype(np.float32)).to(dtype).float()
    f = irf.mma_fragments(w, dtype)
    terms = 1 if dtype == torch.bfloat16 else irf.EXPAND_TERMS
    assert f.shape == (128 // 8, 64 // 16, terms, 32, 4) and f.dtype == torch.bfloat16
    parts = [torch.nn.functional.pad(t, (0, 128 - n, 0, 64 - k))
             for t in ([w] if dtype == torch.bfloat16 else irf.split_bf16(w, terms))]
    for j, s, i, g, t in itertools.product(range(16), range(4), range(terms), range(8),
                                           range(4)):
        # lane 4g + t: b_i[16 s + 2 t + (0, 1, 8, 9)][8 j + g]
        want = torch.stack([parts[i][16 * s + 2 * t + d, 8 * j + g] for d in (0, 1, 8, 9)])
        assert torch.equal(f[j, s, i, 4 * g + t].float(), want)
    total = sum(p.double() for p in parts)[:k, :n]
    assert (total - w.double()).abs().max().item() <= 2.0 ** -24 * w.abs().max().item()


def test_k13_dw1_against_float64(rng):
    """The 128^2 32 -> 64 stage's widths at B=2: dW1 sums x^T de over
    32,768 pixels; the plain version (e from x @ W1) and the same de from
    the kernels' emulated e are both within 1e-4 of scale of float64."""
    B, H, cin, ce = 2, 128, 32, 192
    x = torch.from_numpy(rng.uniform(0, 3, (B, H, H, cin)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(0, np.sqrt(2.0 / cin), (cin, ce)).astype(np.float32))
    dv1 = torch.from_numpy(rng.normal(0, 1, (B, H, H, ce)).astype(np.float32))
    e = irf._rnd(x.reshape(-1, cin) @ w1, torch.float32)
    m1, v1 = e.mean(0), e.var(0, unbiased=False)
    inv1 = torch.rsqrt(v1 + 1e-5)
    u1 = torch.from_numpy(rng.uniform(0.5, 1.5, ce).astype(np.float32)) * inv1
    p1, q1 = u1 * 0.01, u1 * 0.02
    xm = x.reshape(-1, cin).double()
    e64 = xm @ w1.double()
    de64 = u1.double() * dv1.reshape(-1, ce).double() - p1.double() \
        - q1.double() * (e64 - m1.double()) * inv1.double()
    ref = xm.T @ de64
    scale = max(1.0, ref.abs().max().item())

    _, dw1 = irf.expand_bwd_plain(x, w1, m1, inv1, u1, p1, q1, dv1)
    assert (dw1.double() - ref).abs().max().item() <= 1e-4 * scale

    ee = irf.expand_e_emulated(x, w1).reshape(-1, ce)
    de = u1 * dv1.reshape(-1, ce) - p1 - q1 * ((ee - m1) * inv1)
    dw1_e = x.reshape(-1, cin).T @ de
    assert (dw1_e.double() - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_sums_of_the_shared_e_meet_jax_stats1(rng, dtype):
    """BN1's sums at the 128^2 32 -> 64 stage's widths (Cin 32, Ce 192) at
    B=2, 8x8: sum e and sum e^2 of the emulated e against JAX's
    `_stats1_kernel` run as `_ir_train_forward` runs it, within
    chip_smoke.py's check_close for K8 (f32 1e-4, bf16 2e-2, of max(1,
    scale))."""
    B, H, cin, ce = 2, 8, 32, 192
    x = rng.uniform(0, 3, (B, H, H, cin)).astype(np.float32)
    w1 = rng.normal(0, np.sqrt(2.0 / cin), (cin, ce)).astype(np.float32)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    with jax.default_matmul_precision("highest"):
        s, q = pl.pallas_call(
            functools.partial(_stats1_kernel, H=H, W=H), grid=(B,),
            in_specs=[_bspec((B, H, H, cin)), _vspec((cin, ce))],
            out_specs=[_vspec((1, ce)), _vspec((1, ce))],
            out_shape=[jax.ShapeDtypeStruct((1, ce), jnp.float32)] * 2,
            scratch_shapes=[pltpu.VMEM((1, ce), jnp.float32)] * 2,
            interpret=True, compiler_params=_COMPILER_PARAMS,
        )(jnp.asarray(x, jdt), jnp.asarray(w1, jdt))
    e = irf.expand_e_emulated(torch.from_numpy(x).to(tdt), torch.from_numpy(w1))
    got = (e.reshape(-1, ce).sum(0), (e * e).reshape(-1, ce).sum(0))
    for g, w in zip(got, (np.asarray(s)[0], np.asarray(q)[0])):
        scale = max(1.0, np.abs(w).max())
        tol = (1e-4 if dtype == "f32" else 2e-2) * scale
        assert np.abs(g.numpy() - w).max() <= tol
