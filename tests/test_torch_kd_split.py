"""The split arithmetic of the port's feature-MSE kernel (K7), on the CPU.

The kernel forms T.P on bf16 tensor cores from split operands: every f32
value is written as bf16 terms v0 + v1 + v2, each the bf16 rounding of what
the earlier terms left, and the products T_i P_j with i + j < KERNEL_TERMS
are summed in f32 (ops/kd_loss.py). Here:

- the terms of `split_bf16` are bf16 values that sum back to x within
  2^-(8 n) of |x| for n terms (each rounding to nearest keeps 8 significant
  bits of what is left);
- the wrapper's layout of P's terms puts each value where the kernel's
  warpgroup products read it;
- `mse_partials_emulated` (the kernel's arithmetic in plain PyTorch) meets
  the JAX kernel (`_mse_partials`, Pallas in interpret mode, "highest"
  matmul precision) within 1e-5 relative, the limit chip_smoke.py holds the
  kernel to, in f32 and bf16, on a random student and on a near-teacher one
  (S = T.P + 1e-3 N(0, 1), a student that matches its projected teacher);
- KERNEL_TERMS is the fewest terms that keep the near-teacher loss within
  that limit at the main path's widths (Ct = 256, Cs = 128) in f32, against
  a float64 reference: one fewer misses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.ops.kd_loss_pallas import _mse_partials as jax_mse_partials
from lmsu_tpu_torch.ops.kd_loss import (KERNEL_TERMS, fragment_terms, kernel_products,
                                        mse_partials_emulated, split_bf16)

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(707)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_terms_sum_back(rng, terms):
    x = torch.from_numpy(rng.normal(0, 1, 4096).astype(np.float32)) * torch.from_numpy(
        np.exp2(rng.integers(-20, 20, 4096)).astype(np.float32))
    parts = split_bf16(x, terms)
    assert len(parts) == terms
    for p in parts:
        assert p.dtype == torch.float32
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    total = torch.zeros_like(x)
    for p in parts:
        total = total + p
    assert torch.all((x.double() - total.double()).abs() <= 2.0 ** (-8 * terms) * x.abs().double())


def test_kernel_products():
    assert kernel_products(torch.bfloat16) == KERNEL_TERMS
    assert kernel_products(torch.float32) == KERNEL_TERMS * (KERNEL_TERMS + 1) // 2


@pytest.mark.parametrize("ct,cs", [(64, 100), (40, 128)])
def test_fragment_terms_layout(rng, ct, cs):
    p = torch.from_numpy(rng.normal(0, 1, (ct, cs)).astype(np.float32))
    terms = fragment_terms(p)
    ctp, csp = -(-ct // 64) * 64, -(-cs // 64) * 64
    assert terms.shape == (ctp // 16, KERNEL_TERMS, csp // 8, 2, 8, 8)
    assert terms.dtype == torch.bfloat16 and terms.is_contiguous()
    split = [torch.nn.functional.pad(t, (0, csp - cs, 0, ctp - ct)) for t in split_bf16(p)]
    for i in range(KERNEL_TERMS):
        # core matrix (n-group ng, k-half h) of k-step s holds P_i[16 s + 8 h + k][8 ng + n]
        # at [n][k]; rows past Ct and columns past Cs are zeros
        want = split[i].reshape(ctp // 16, 2, 8, csp // 8, 8).permute(0, 3, 1, 4, 2)
        assert torch.equal(terms[:, i].float(), want)
    s, i, ng, h, n, k = 2, 1, 3, 0, 5, 6
    assert terms[s, i, ng, h, n, k].float() == split[i][16 * s + 8 * h + k, 8 * ng + n]


def _inputs(rng, dtype, kind, B=3, M=700, cs=16, ct=48):
    t = rng.normal(0, 1, (B, M, ct)).astype(np.float32)
    p = rng.normal(0, 1 / np.sqrt(ct), (ct, cs)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tt = torch.from_numpy(t).to(tdt)
    if kind == "random":
        s = torch.from_numpy(rng.normal(0, 1, (B, M, cs)).astype(np.float32))
    else:
        noise = torch.from_numpy(rng.normal(0, 1, (B, M, cs)).astype(np.float32))
        s = (tt.double() @ torch.from_numpy(p).double()).float() + 1e-3 * noise
    return s.to(tdt), tt, torch.from_numpy(p)


@pytest.mark.parametrize("kind", ["random", "near_teacher"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulation_equals_jax_kernel(rng, dtype, kind):
    s, t, p = _inputs(rng, dtype, kind)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    to_j = lambda a: jnp.asarray(a.float().numpy(), jdt)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_mse_partials(to_j(s), to_j(t), jnp.asarray(p.numpy())))[:, 0]
    got = mse_partials_emulated(s, t, p)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_kernel_terms_are_the_fewest_that_hold_the_limit(rng):
    s, t, p = _inputs(rng, "f32", "near_teacher", B=2, M=512, cs=128, ct=256)
    ref = (s.double() - t.double() @ p.double()).square().sum((1, 2))

    def rel(terms):
        got = mse_partials_emulated(s, t, p, terms=terms).double()
        return ((got - ref).abs().max() / ref.abs().max()).item()

    assert rel(KERNEL_TERMS) <= 2.5e-6
    assert rel(KERNEL_TERMS - 1) > 1e-5
