"""The port's KD feature-matching loss against the JAX package's, on the CPU:
the plain version of the feature-MSE kernel (ops/kd_loss.py) against
`_mse_partials` (Pallas in interpret mode), `fused_feature_mse` and
`kd_total_loss_fused` with and without `sample_weight`, and the
gradients of the port's autograd Function against jax.grad.

Tolerances (f32, JAX at "highest" matmul precision): rtol 1e-5 on losses
and partial sums (the same sums in another order); gradients rtol 1e-5,
atol 1e-7. bf16 taps: rtol 1e-3 (the upcast operands are exact; only the
f32 summation order differs, over larger values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.ops.kd_loss_pallas import _mse_partials as jax_mse_partials
from lmsu_tpu.ops.kd_loss_pallas import fused_feature_mse as jax_fused_feature_mse
from lmsu_tpu.ops.kd_loss_pallas import kd_total_loss_fused as jax_kd_total_loss_fused
from lmsu_tpu.ops.losses import kd_total_loss as jax_kd_total_loss
from lmsu_tpu_torch.ops.kd_loss import (fused_feature_mse, kd_total_loss_fused,
                                        mse_partials, mse_partials_plain)
from lmsu_tpu_torch.ops.losses import kd_total_loss

torch.set_num_threads(2)

TAPS = ("camera_feat", "lidar_feat", "post_fusion")


@pytest.fixture
def rng():
    return np.random.default_rng(707)


def _taps(rng, B=2, H=8, cs=16, ct=32):
    s = {t: rng.normal(0, 1, (B, H, H, cs)).astype(np.float32) for t in TAPS}
    t_ = {t: rng.normal(0, 1, (B, H, H, ct)).astype(np.float32) for t in TAPS}
    p = {t: (rng.normal(0, 1, (ct, cs)) / np.sqrt(ct)).astype(np.float32) for t in TAPS}
    return s, t_, p


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_partials_plain_equals_jax_kernel(rng, dtype):
    s = rng.normal(0, 1, (3, 700, 16)).astype(np.float32)   # M not a tile multiple
    t = rng.normal(0, 1, (3, 700, 48)).astype(np.float32)
    p = rng.normal(0, 0.2, (48, 16)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_mse_partials(jnp.asarray(s, jdt), jnp.asarray(t, jdt),
                                           jnp.asarray(p)))[:, 0]
    ts, tt = torch.from_numpy(s).to(tdt), torch.from_numpy(t).to(tdt)
    got = mse_partials(ts, tt, torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5 if dtype == "f32" else 1e-3)
    assert torch.equal(got, mse_partials_plain(ts, tt, torch.from_numpy(p)))


def test_fused_feature_mse_value_and_grads(rng):
    s, t, p = (a["camera_feat"] for a in _taps(rng))
    with jax.default_matmul_precision("highest"):
        want, jgrads = jax.value_and_grad(
            lambda a, b, c: jax_fused_feature_mse(a, b, c) * 3.0, argnums=(0, 1, 2))(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(p))
    ts, tt, tp = (torch.from_numpy(a).requires_grad_(True) for a in (s, t, p))
    got = fused_feature_mse(ts, tt, tp) * 3.0
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip((ts.grad, tt.grad, tp.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True], ids=["no_weight", "sample_weight"])
def test_kd_total_loss_fused_matches_jax(rng, weighted):
    s, t, p = _taps(rng)
    sl = rng.normal(0, 2, (2, 8, 8, 2)).astype(np.float32)
    tl = rng.normal(0, 2, (2, 8, 8, 2)).astype(np.float32)
    y = rng.integers(-1, 2, (2, 8, 8))
    w = np.array([True, False]) if weighted else None
    kw = dict(class_weights=np.array([0.4, 3.5], np.float32), ignore_index=-1,
              temperature=2.0, alpha_kl=0.5, beta_feature=0.5, feature_taps=TAPS)

    def jax_loss(sl_, sf, pr, impl):
        return impl(sl_, jnp.asarray(tl), sf, {k: jnp.asarray(v) for k, v in t.items()},
                    jnp.asarray(y), projections=pr,
                    sample_weight=None if w is None else jnp.asarray(w), **kw)[0]

    args = (jnp.asarray(sl), {k: jnp.asarray(v) for k, v in s.items()},
            {k: jnp.asarray(v) for k, v in p.items()})
    with jax.default_matmul_precision("highest"):
        want, jgrads = jax.value_and_grad(
            lambda *a: jax_loss(*a, jax_kd_total_loss_fused), argnums=(0, 1, 2))(*args)
        want_plain = jax_loss(*args, jax_kd_total_loss)

    tsl = torch.from_numpy(sl).requires_grad_(True)
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in s.items()}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tkw = dict(kw, class_weights=torch.tensor([0.4, 3.5]))
    targs = (torch.from_numpy(tl), {k: torch.from_numpy(v) for k, v in t.items()},
             torch.from_numpy(y))
    sw = None if w is None else torch.from_numpy(w)
    got, parts = kd_total_loss_fused(tsl, targs[0], ts, targs[1], targs[2], projections=tp,
                                     sample_weight=sw, **tkw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(want_plain), rtol=1e-5)
    assert set(parts) == {"ce", "kl", "feature_mse", "total"}
    np.testing.assert_allclose(tsl.grad.numpy(), np.asarray(jgrads[0]), rtol=1e-5, atol=1e-7)
    for k in TAPS:
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(jgrads[1][k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[2][k]),
                                   rtol=1e-5, atol=1e-7)
    # The port's fused and plain losses agree with each other too.
    plain, _ = kd_total_loss(tsl.detach(), targs[0], {k: v.detach() for k, v in ts.items()},
                             targs[1], targs[2], projections=tp, sample_weight=sw, **tkw)
    np.testing.assert_allclose(float(plain.detach()), float(got.detach()), rtol=1e-5)


def test_bf16_taps(rng):
    """bf16 taps are upcast inside the loss; the result is f32."""
    s, t, p = (a["lidar_feat"] for a in _taps(rng))
    with jax.default_matmul_precision("highest"):
        want = float(jax_fused_feature_mse(jnp.asarray(s, jnp.bfloat16),
                                           jnp.asarray(t, jnp.bfloat16), jnp.asarray(p)))
    got = fused_feature_mse(torch.from_numpy(s).bfloat16(), torch.from_numpy(t).bfloat16(),
                            torch.from_numpy(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-3)
