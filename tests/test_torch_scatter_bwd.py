"""The backward of the port's BEV scatter-max against jax.grad of the JAX
package's, on the CPU: the plain version of the sorted-scatter backward
kernel (ops/scatter_sorted.py::segment_max_bwd_plain, reached through the
autograd Function) against the Pallas custom VJP in interpret mode, and the
plain unsorted scatter's autograd against jax.grad of the XLA scatter.

Tolerance: exact in f32 and in bf16. Both sides compute the same f32
division g / ties and round once to the feature dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jax_jit

from lmsu_tpu.ops.scatter import bev_scatter_max as jax_bev_scatter_max
from lmsu_tpu.ops.scatter_sorted_pallas import (
    bev_scatter_max_sorted_pallas as jax_sorted_pallas)
from lmsu_tpu_torch.ops.scatter import bev_scatter_max
from lmsu_tpu_torch.ops.scatter_sorted import (bev_scatter_max_sorted_pallas, cell_keys,
                                               segment_max_bwd, segment_max_bwd_plain,
                                               segment_max_plain)

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(515)


def _sorted_case(rng, B, N, C, grid, invalid_frac=0.3, hot_cells=None, quantize=True,
                 relu=False):
    hw = grid[0] * grid[1]
    feats = rng.normal(0, 1, (B, N, C)).astype(np.float32)
    if quantize:  # coarse values: ties inside cells
        feats = np.round(feats * 2) / 2
    if relu:  # exact zeros, and cells whose max is 0
        feats = np.maximum(feats, 0)
    cells = hot_cells if hot_cells is not None else np.arange(hw)
    idx = rng.choice(cells, (B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) >= invalid_frac
    order = np.argsort(np.where(valid, idx, hw), axis=-1, kind="stable")
    return (np.take_along_axis(feats, order[..., None], 1),
            np.take_along_axis(idx, order, 1), np.take_along_axis(valid, order, 1))


CASES = {
    "grid16_two_tiles": dict(B=2, N=600, C=128, grid=(16, 16)),
    "c256": dict(B=1, N=300, C=256, grid=(8, 8)),
    "relu_zero_max_cells": dict(B=2, N=400, C=16, grid=(8, 8), relu=True),
    "ties_over_256": dict(B=1, N=700, C=8, grid=(4, 4), hot_cells=np.array([5]),
                          invalid_frac=0.05),
    "all_invalid": dict(B=1, N=64, C=8, grid=(4, 4), invalid_frac=1.1),
}


def _jax_grad(fn, feats, idx, valid, grid, g, dtype):
    """The VJP of `fn` at feats for cotangent g, under jax_jit."""
    def vjp(f, i, v, g):
        _, back = jax.vjp(lambda f: fn(f, i, v, grid), f)
        return back(g)[0]

    with jax.default_matmul_precision("highest"):  # the Pallas kernel counts ties by matmul
        d = jax_jit(vjp)(jnp.asarray(feats, dtype), jnp.asarray(idx), jnp.asarray(valid),
                         jnp.asarray(g, dtype))
    return np.asarray(d.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_sorted_backward_equals_jax_grad(rng, case, dtype):
    kw = dict(CASES[case])
    grid = kw["grid"]
    feats, idx, valid = _sorted_case(rng, **kw)
    if case == "ties_over_256":
        feats[:, :, 0] = 1.0  # ~665 points of one cell tie in channel 0
    g = rng.normal(0, 1, (kw["B"], *grid, kw["C"])).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    want = _jax_grad(jax_sorted_pallas, feats, idx, valid, grid, g, jdt)

    tf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    out = bev_scatter_max_sorted_pallas(tf, torch.from_numpy(idx), torch.from_numpy(valid), grid)
    out.backward(torch.from_numpy(g).to(tdt))
    assert tf.grad.dtype == tdt
    np.testing.assert_array_equal(tf.grad.float().numpy(), want)
    if case == "ties_over_256":
        n_tied = int(valid.sum())
        assert n_tied > 256
        np.testing.assert_array_equal(want[0, :n_tied, 0] != 0, True)
    if case == "all_invalid":
        assert not tf.grad.any()


def test_plain_backward_function_directly(rng):
    """segment_max_bwd on CPU tensors is the plain version."""
    feats, idx, valid = _sorted_case(rng, 2, 300, 32, (8, 8))
    tf = torch.from_numpy(feats)
    keys = cell_keys(torch.from_numpy(idx), torch.from_numpy(valid), 64)
    out = segment_max_plain(tf, keys, 64)
    g = torch.from_numpy(rng.normal(0, 1, out.shape).astype(np.float32))
    assert torch.equal(segment_max_bwd(tf, keys, out, g, 64),
                       segment_max_bwd_plain(tf, keys, out, g, 64))


@pytest.mark.parametrize("relu", [False, True], ids=["signed", "relu"])
def test_unsorted_scatter_autograd_equals_jax_grad(rng, relu):
    """The plain scatter (scatter_impl="xla") splits a cell's gradient over
    its tied points only, as the JAX package's -inf-initialised scatter
    does, also in cells whose max is exactly 0."""
    feats, idx, valid = _sorted_case(rng, 2, 500, 16, (8, 8), relu=relu)
    perm = rng.permutation(500)
    feats, idx, valid = feats[:, perm], idx[:, perm], valid[:, perm]
    g = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    want = _jax_grad(jax_bev_scatter_max, feats, idx, valid, (8, 8), g, jnp.float32)
    tf = torch.from_numpy(feats).requires_grad_(True)
    bev_scatter_max(tf, torch.from_numpy(idx), torch.from_numpy(valid), (8, 8)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(tf.grad.numpy(), want, rtol=1e-6, atol=1e-7)
