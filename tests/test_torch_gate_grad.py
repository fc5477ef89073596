"""Gradients of the port's fusion-gate autograd Function (ops/fusion_gate.py:
kernel or plain forward, plain backward) against jax.grad of the JAX
package's `weighted_fusion_gate` (Pallas forward in interpret mode, custom
VJP), on the CPU, for every argument: cam, lid, w1, b1, w2, b2.

Tolerance: f32 rtol 1e-5 / atol 1e-5 on gradients of magnitude up to ~3
(the same products summed in another order; JAX at "highest" matmul
precision). bf16 features: the feature gradients are rounded to bf16 on
both sides, so rtol 2e-2 there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.ops.fusion_pallas import weighted_fusion_gate as jax_gate
from lmsu_tpu_torch.ops.fusion_gate import fusion_gate, fusion_gate_bwd

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(909)


def _inputs(rng, C, B=2, H=6):
    cam = rng.normal(0, 1, (B, H, H, C)).astype(np.float32)
    lid = rng.normal(0, 1, (B, H, H, C)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (1, 1, 2 * C, C)).astype(np.float32)   # JAX layouts
    b1 = rng.normal(0, 0.1, (C,)).astype(np.float32)
    w2 = rng.normal(0, 0.3, (1, 1, C, 2)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (2,)).astype(np.float32)
    r = rng.normal(0, 1, (B, H, H, C)).astype(np.float32)
    return cam, lid, w1, b1, w2, b2, r


def _to_torch_layout(w1, w2, C):
    """JAX [1,1,2C,C] / [1,1,C,2] -> torch [C,2C,1,1] / [2,C,1,1]."""
    return (np.ascontiguousarray(w1[0, 0].T).reshape(C, 2 * C, 1, 1),
            np.ascontiguousarray(w2[0, 0].T).reshape(2, C, 1, 1))


@pytest.mark.parametrize("C", [16, 32])
def test_gate_gradients_match_jax(rng, C):
    cam, lid, w1, b1, w2, b2, r = _inputs(rng, C)
    with jax.default_matmul_precision("highest"):
        want, jg = jax.value_and_grad(
            lambda *a: jnp.sum(jax_gate(*a) * r), argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (cam, lid, w1, b1, w2, b2)))
    tw1, tw2 = _to_torch_layout(w1, w2, C)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (cam, lid, tw1, b1, tw2, b2)]
    out = fusion_gate(*args)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(float((out.detach() * torch.from_numpy(r)).sum()),
                               float(want), rtol=1e-5)
    d_w1, d_w2 = _to_torch_layout(np.asarray(jg[2]), np.asarray(jg[4]), C)
    for got, w in zip(args, (jg[0], jg[1], d_w1, jg[3], d_w2, jg[5])):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gate_gradients_bf16_features(rng):
    C = 16
    cam, lid, w1, b1, w2, b2, r = _inputs(rng, C)
    with jax.default_matmul_precision("highest"):
        jg = jax.grad(lambda c, l: jnp.sum(jax_gate(c, l, *(jnp.asarray(a) for a in
                                                           (w1, b1, w2, b2))).astype(
            jnp.float32) * r), argnums=(0, 1))(jnp.asarray(cam, jnp.bfloat16),
                                               jnp.asarray(lid, jnp.bfloat16))
    tw1, tw2 = _to_torch_layout(w1, w2, C)
    tc = torch.from_numpy(cam).bfloat16().requires_grad_(True)
    tl = torch.from_numpy(lid).bfloat16().requires_grad_(True)
    out = fusion_gate(tc, tl, *(torch.from_numpy(a) for a in (tw1, b1, tw2, b2)))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(r)).sum().backward()
    for got, w in zip((tc.grad, tl.grad), jg):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_backward_is_the_autograd_of_the_plain_forward(rng):
    """The hand-written backward equals autograd through the unfused
    softmax form of the gate (models/fusion.py's plain path)."""
    C = 8
    cam, lid, w1, b1, w2, b2, r = _inputs(rng, C)
    tw1, tw2 = _to_torch_layout(w1, w2, C)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (cam, lid, tw1, b1, tw2, b2)]
    c, l_, a1, ab1, a2, ab2 = args
    h = torch.relu(torch.cat([c, l_], -1) @ a1.reshape(C, 2 * C).T + ab1)
    wts = torch.softmax(h @ a2.reshape(2, C).T + ab2, dim=-1)
    out = c * wts[..., :1] + l_ * wts[..., 1:]
    want = torch.autograd.grad((out * torch.from_numpy(r).double()).sum(), args)
    got = fusion_gate_bwd(*(a.detach().float() for a in args), torch.from_numpy(r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6)
