"""The plain version of the port's fusion-gate kernel (ops/fusion_gate.py)
against the JAX package's Pallas gate (interpret mode on the CPU), and the
port's WeightedFusion module with the gate fused and unfused.

The kernel's own arithmetic (the 1x1 product on bf16 tensor cores, W1 split
into GATE_TERMS bf16 terms in both types, f32 features as many, bf16
features one exact term) is held here through `fusion_gate_emulated`, that
arithmetic in plain PyTorch: it meets the JAX gate, and GATE_TERMS is the
fewest terms that keep a within 1e-6 of its scale of a float64 product.
The kernel itself runs only on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.ops.fusion_pallas import weighted_fusion_gate
from lmsu_tpu_torch.models.fusion import WeightedFusion
from lmsu_tpu_torch.ops import fusion_gate as fg
from lmsu_tpu_torch.ops.fusion_gate import fusion_gate, fusion_gate_plain

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _gate_inputs(rng, shape):
    C = shape[-1]
    cam = rng.normal(0, 1, shape).astype(np.float32)
    lid = rng.normal(0, 1, shape).astype(np.float32)
    w1 = rng.normal(0, 0.1, (1, 1, 2 * C, C)).astype(np.float32)   # flax layout
    b1 = rng.normal(0, 0.1, (C,)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (1, 1, C, 2)).astype(np.float32)
    b2 = rng.normal(0, 0.2, (2,)).astype(np.float32)
    return cam, lid, w1, b1, w2, b2


def _torch_weights(w1, b1, w2, b2):
    """flax [1, 1, I, O] -> torch Conv2d [O, I, 1, 1]."""
    t = torch.from_numpy
    return (t(w1.transpose(3, 2, 0, 1).copy()), t(b1), t(w2.transpose(3, 2, 0, 1).copy()),
            t(b2))


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 5, 7, 32), (2, 8, 8, 256)])
def test_plain_gate_matches_jax_pallas(rng, shape):
    cam, lid, w1, b1, w2, b2 = _gate_inputs(rng, shape)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(weighted_fusion_gate(*(jnp.asarray(a) for a in
                                                 (cam, lid, w1, b1, w2, b2))))
    got = fusion_gate(torch.from_numpy(cam), torch.from_numpy(lid),
                      *_torch_weights(w1, b1, w2, b2))
    assert got.shape == cam.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_gate_bf16_matches_jax_pallas(rng):
    """bf16 features: f32 arithmetic inside, output rounded once to bf16 on
    both sides (tolerance: one bf16 step at |x| < 4)."""
    cam, lid, w1, b1, w2, b2 = _gate_inputs(rng, (1, 8, 8, 128))
    camb = jnp.asarray(cam, jnp.bfloat16)
    lidb = jnp.asarray(lid, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(weighted_fusion_gate(camb, lidb, *(jnp.asarray(a) for a in
                                                             (w1, b1, w2, b2)))
                          .astype(jnp.float32))
    got = fusion_gate(torch.from_numpy(cam).bfloat16(), torch.from_numpy(lid).bfloat16(),
                      *_torch_weights(w1, b1, w2, b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.6e-2)


def test_weighted_fusion_fused_equals_unfused_softmax(rng):
    """The module's two paths: the fused gate (sigmoid of the logit
    difference) and the reference's softmax over two 1x1-conv logits."""
    torch.manual_seed(0)
    fused = WeightedFusion(32, 16, 32, use_fused_gate=True).eval()
    plain = WeightedFusion(32, 16, 32, use_fused_gate=False).eval()
    with torch.no_grad():
        for m in fused.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 2.0)
    plain.load_state_dict(fused.state_dict())
    cam = torch.from_numpy(rng.normal(0, 1, (2, 32, 6, 6)).astype(np.float32))
    lid = torch.from_numpy(rng.normal(0, 1, (2, 16, 6, 6)).astype(np.float32))
    with torch.no_grad():
        a, _ = fused(cam, lid)
        b, _ = plain(cam, lid)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_plain_gate_is_the_cpu_path(rng):
    cam, lid, w1, b1, w2, b2 = _gate_inputs(rng, (1, 2, 2, 32))
    args = (torch.from_numpy(cam), torch.from_numpy(lid), *_torch_weights(w1, b1, w2, b2))
    assert torch.equal(fusion_gate(*args), fusion_gate_plain(*args))


def _jax_gate(cam, lid, w1, b1, w2, b2, jdt):
    with jax.default_matmul_precision("highest"):
        return np.asarray(weighted_fusion_gate(
            jnp.asarray(cam, jdt), jnp.asarray(lid, jdt),
            *(jnp.asarray(a) for a in (w1, b1, w2, b2))).astype(jnp.float32))


@pytest.mark.parametrize("C", [32, 128, 40])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_kernel_matches_jax_pallas(rng, C, dtype):
    """The kernel's split-term product (C=40: each half of K padded from 40
    to 48 channels) with f32 W1 in both types. f32 within the plain
    version's 1e-5; bf16 within one bf16 step at |x| < 4, as above."""
    cam, lid, w1, b1, w2, b2 = _gate_inputs(rng, (1, 8, 8, C))
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    want = _jax_gate(cam, lid, w1, b1, w2, b2, jdt)
    got = fg.fusion_gate_emulated(torch.from_numpy(cam).to(tdt), torch.from_numpy(lid).to(tdt),
                                  *_torch_weights(w1, b1, w2, b2))
    assert got.shape == cam.shape and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if dtype == "f32" else 1.6e-2)


@pytest.mark.parametrize("C,dtype", [(128, torch.float32), (256, torch.float32),
                                     (128, torch.bfloat16)])
def test_gate_terms_are_the_fewest_that_hold_the_limit(rng, C, dtype):
    """a = [cam | lid] W1^T + b1 from the kernel's arithmetic against
    float64, at the student's and the teacher's C: within 1e-6 of its scale
    with GATE_TERMS (W1 is f32 for bf16 features too, so they need as many
    W1 terms), beyond it with one fewer."""
    cam, lid, w1, b1, _, _ = _gate_inputs(rng, (1, 16, 16, C))
    tw1, tb1 = _torch_weights(w1, b1, w1, b1)[:2]
    tc, tl = torch.from_numpy(cam).to(dtype), torch.from_numpy(lid).to(dtype)
    ref = (torch.cat([tc.double(), tl.double()], -1).reshape(-1, 2 * C)
           @ tw1.reshape(C, 2 * C).double().T + tb1.double())

    def rel(terms):
        got = fg.gate_logits_emulated(tc, tl, tw1, tb1, terms)
        return ((got.double() - ref).abs().max() / ref.abs().max()).item()

    assert rel(fg.GATE_TERMS) <= 1e-6
    assert rel(fg.GATE_TERMS - 1) > 1e-6


def test_gate_products():
    assert fg.gate_products(torch.float32) == fg.GATE_TERMS * (fg.GATE_TERMS + 1) // 2
    assert fg.gate_products(torch.bfloat16) == fg.GATE_TERMS
