"""The unsorted scatter-max of scatter_impl="pallas" (ops/voxelize.py)
against the JAX package's bev_scatter_max_pallas (its Pallas kernel in
interpret mode, its jnp backward), on the CPU, where the port's wrapper runs
the kernel's plain version: forward bit for bit, the gradient of sum(out^2)
at atol 1e-6 (both split a cell's gradient over its tied winners in f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jax_jit

from lmsu_tpu.ops.voxelize_pallas import bev_scatter_max_pallas as jax_pallas
from lmsu_tpu_torch.ops import voxelize
from lmsu_tpu_torch.ops.scatter import bev_scatter_max
from lmsu_tpu_torch.ops.voxelize import bev_scatter_max_pallas, scatter_max, scatter_max_plain

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(404)


def _case(rng, B, N, C, grid, invalid_frac=0.3, hot=0, negative=False):
    """Points in no order, coarse features (ties within cells), a share of
    invalid points, and optionally `hot` points of each cloud in one cell
    (as zero-padded points all fall in the grid's centre cell)."""
    hw = grid[0] * grid[1]
    feats = np.round(rng.normal(0, 1, (B, N, C)) * 2).astype(np.float32) / 2
    if negative:
        feats = -np.abs(feats) - 0.5
    idx = rng.integers(0, hw, (B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) >= invalid_frac
    if hot:
        at = rng.choice(N, hot, replace=False)
        idx[:, at] = hw // 2 + grid[1] // 2
        valid[:, at] = True
    return feats, idx, valid


CASES = {
    "ties_and_invalid": dict(B=2, N=300, C=16, grid=(8, 8)),
    "hot_cell": dict(B=2, N=300, C=8, grid=(8, 8), hot=120),
    "all_invalid": dict(B=1, N=64, C=8, grid=(4, 4), invalid_frac=1.1),
    "all_negative": dict(B=1, N=64, C=8, grid=(4, 4), negative=True),
    "rect_grid": dict(B=2, N=200, C=4, grid=(6, 10)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_pallas_scatter_equals_jax(rng, case, dtype):
    kw = dict(CASES[case])
    grid = kw["grid"]
    feats, idx, valid = _case(rng, **kw)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jf, ji, jv = jnp.asarray(feats, jdt), jnp.asarray(idx), jnp.asarray(valid)

    def ref(f):
        out = jax_pallas(f, ji, jv, grid).astype(jnp.float32)
        return out, jax.grad(lambda f: jnp.sum(
            jax_pallas(f, ji, jv, grid).astype(jnp.float32) ** 2))(f).astype(jnp.float32)

    want, want_g = (np.asarray(a) for a in jax_jit(ref)(jf))

    tf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    out = bev_scatter_max_pallas(tf, torch.from_numpy(idx), torch.from_numpy(valid), grid)
    assert out.dtype == tdt and out.shape == (kw["B"], *grid, kw["C"])
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    (out.float() ** 2).sum().backward()
    assert tf.grad.dtype == tdt
    np.testing.assert_allclose(tf.grad.float().numpy(), want_g, atol=1e-6, rtol=0)
    if case == "all_invalid":
        assert not out.any() and not tf.grad.any()
    if case == "all_negative":
        touched = np.zeros(grid[0] * grid[1], bool)
        touched[idx[0][valid[0]]] = True
        assert (out.detach().reshape(-1, kw["C"])[torch.from_numpy(touched)] < 0).all()


def test_plain_version_is_the_xla_scatter_and_ignores_order(rng):
    """scatter_max_plain on indices with hw for invalid points equals the
    plain unsorted scatter, and a permutation of the points changes no bit."""
    feats, idx, valid = _case(rng, 2, 250, 8, (8, 8), hot=60)
    hw = 64
    tf, ti, tv = (torch.from_numpy(a) for a in (feats, idx, valid))
    keys = torch.where(tv, ti, hw).to(torch.int32)
    got = scatter_max_plain(tf, keys, hw)
    assert torch.equal(got.reshape(2, 8, 8, 8), bev_scatter_max(tf, ti, tv, (8, 8)))
    perm = torch.from_numpy(rng.permutation(250))
    assert torch.equal(scatter_max_plain(tf[:, perm], keys[:, perm], hw), got)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    feats, idx, valid = _case(rng, 1, 50, 4, (4, 4))
    before = voxelize.KERNEL.launches
    keys = torch.from_numpy(np.where(valid, idx, 16).astype(np.int32))
    out = scatter_max(torch.from_numpy(feats), keys, 16)
    assert torch.equal(out, scatter_max_plain(torch.from_numpy(feats), keys, 16))
    assert voxelize.KERNEL.launches == before and voxelize.KERNEL._lib is None
