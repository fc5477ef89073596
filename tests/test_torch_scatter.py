"""The port's BEV cell mapping, host sort key, sorters and scatters against
the JAX package, exactly (CPU; the JAX sorted kernel in interpret mode).

The plain version of the sorted-scatter kernel (ops/scatter_sorted.py) is
held bit for bit against both JAX scatters on sorted input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.data.rasterize import bev_cell_key as jax_bev_cell_key
from lmsu_tpu.data.rasterize import make_point_sorter as jax_make_point_sorter
from lmsu_tpu.ops.scatter import bev_scatter_max as jax_bev_scatter_max
from lmsu_tpu.ops.scatter import points_to_bev_indices as jax_indices
from lmsu_tpu.ops.scatter_sorted_pallas import (
    bev_scatter_max_sorted_pallas as jax_sorted_pallas)
from lmsu_tpu.ops.scatter_sorted_pallas import (
    sort_points_by_bev_cell as jax_sort_points)
from lmsu_tpu_torch.data.rasterize import bev_cell_key, make_point_sorter
from lmsu_tpu_torch.ops.scatter import bev_scatter_max, points_to_bev_indices
from lmsu_tpu_torch.ops.scatter_sorted import (bev_scatter_max_sorted, cell_keys,
                                               segment_max, sort_points_by_bev_cell)

torch.set_num_threads(2)

PC = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)


@pytest.fixture
def rng():
    """A fresh generator per test, shared with no other test file."""
    return np.random.default_rng(2024)


def _points(rng, B, N, grid):
    """Gaussian clouds plus points exactly on cell boundaries, on the range
    edges and just outside them."""
    H, W = grid
    pts = rng.normal(0, 35, (B, N, 4)).astype(np.float32)
    k = rng.integers(0, W, (B, N // 4))
    pts[:, :N // 4, 0] = (np.float32(-50) + k.astype(np.float32)
                          * np.float32(100.0 / (W - 1)))
    edge = np.array([-50.0, 50.0, np.nextafter(np.float32(50), np.float32(60)),
                     np.nextafter(np.float32(-50), np.float32(-60))], np.float32)
    pts[:, N // 4:N // 4 + 8, 1] = np.tile(edge, 2)
    return pts


@pytest.mark.parametrize("grid", [(16, 16), (64, 64), (12, 20)])
def test_indices_and_host_key_match_jax(rng, grid):
    pts = _points(rng, 2, 500, grid)
    pv = rng.uniform(size=(2, 500)) > 0.2
    j_idx, j_valid = jax_indices(jnp.asarray(pts[..., :2]), grid, PC)
    idx, valid = points_to_bev_indices(torch.from_numpy(pts[..., :2]), grid, PC)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    key = bev_cell_key(pts, grid, PC, pv)
    np.testing.assert_array_equal(key, jax_bev_cell_key(pts, grid, PC, pv))
    # The host key the points are sorted by IS the device index.
    dev_key = cell_keys(idx, valid & torch.from_numpy(pv), grid[0] * grid[1])
    np.testing.assert_array_equal(dev_key.numpy(), key)


def test_point_sorters_match_jax(rng):
    pts = _points(rng, 1, 400, (64, 64))[0]
    pv = rng.uniform(size=400) > 0.3
    got = make_point_sorter((64, 64), PC)({"points": pts, "point_valid": pv})
    want = jax_make_point_sorter((64, 64), PC)({"points": pts, "point_valid": pv})
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["point_valid"], want["point_valid"])
    d_pts, d_pv = sort_points_by_bev_cell(torch.from_numpy(pts)[None], (64, 64), PC,
                                          torch.from_numpy(pv)[None])
    j_pts, j_pv = jax_sort_points(jnp.asarray(pts)[None], (64, 64), PC,
                                  jnp.asarray(pv)[None])
    np.testing.assert_array_equal(d_pts.numpy(), np.asarray(j_pts))
    np.testing.assert_array_equal(d_pv.numpy(), np.asarray(j_pv))


def _sorted_case(rng, B, N, C, grid, invalid_frac=0.3, hot_cells=None,
                 negative=False, quantize=False):
    hw = grid[0] * grid[1]
    feats = rng.normal(0, 1, (B, N, C)).astype(np.float32)
    if quantize:  # coarse values: ties within and across chunks
        feats = np.round(feats * 2) / 2
    if negative:
        feats = -np.abs(feats) - 1.0
    cells = hot_cells if hot_cells is not None else np.arange(hw)
    idx = rng.choice(cells, (B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) >= invalid_frac
    order = np.argsort(np.where(valid, idx, hw), axis=-1, kind="stable")
    return (np.take_along_axis(feats, order[..., None], 1),
            np.take_along_axis(idx, order, 1), np.take_along_axis(valid, order, 1))


CASES = {
    "grid16_two_tiles": dict(B=2, N=600, C=128, grid=(16, 16)),
    "c256": dict(B=1, N=300, C=256, grid=(8, 8)),
    "bf16": dict(B=2, N=300, C=128, grid=(8, 8), dtype="bf16"),
    "ties_across_chunks": dict(B=1, N=700, C=16, grid=(8, 8), hot_cells=np.array([3, 9]),
                               quantize=True, invalid_frac=0.0),
    "all_invalid": dict(B=1, N=64, C=8, grid=(4, 4), invalid_frac=1.1),
    "all_negative": dict(B=1, N=64, C=8, grid=(4, 4), negative=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sorted_scatter_plain_equals_jax_bitwise(rng, case):
    kw = dict(CASES[case])
    dtype = kw.pop("dtype", "f32")
    grid = kw["grid"]
    feats, idx, valid = _sorted_case(rng, **kw)
    jf = jnp.asarray(feats, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tf = torch.from_numpy(feats).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want_pallas = np.asarray(jax_sorted_pallas(jf, jnp.asarray(idx), jnp.asarray(valid), grid)
                             .astype(jnp.float32))
    want_xla = np.asarray(jax_bev_scatter_max(jf, jnp.asarray(idx), jnp.asarray(valid), grid)
                          .astype(jnp.float32))
    got = bev_scatter_max_sorted(tf, torch.from_numpy(idx), torch.from_numpy(valid), grid)
    assert got.dtype == tf.dtype and got.shape == (kw["B"], *grid, kw["C"])
    np.testing.assert_array_equal(got.float().numpy(), want_pallas)
    np.testing.assert_array_equal(got.float().numpy(), want_xla)
    unsorted = bev_scatter_max(tf, torch.from_numpy(idx), torch.from_numpy(valid), grid)
    np.testing.assert_array_equal(unsorted.float().numpy(), want_xla)
    if case == "all_invalid":
        assert not got.any()
    if case == "all_negative":
        touched = np.zeros(grid[0] * grid[1], bool)
        touched[idx[0][valid[0]]] = True
        assert (got.reshape(-1, kw["C"])[torch.from_numpy(touched)] < 0).all()


def test_sort_contract_breaks_on_unsorted_input(rng):
    """The plain version follows the kernel's algorithm, so a broken sort
    order shows up on the CPU too."""
    feats, idx, valid = _sorted_case(rng, 1, 200, 8, (4, 4), invalid_frac=0.0)
    perm = rng.permutation(200)
    tf, ti, tv = (torch.from_numpy(a[:, perm]) for a in (feats, idx, valid))
    right = bev_scatter_max(tf, ti, tv, (4, 4))
    wrong = segment_max(tf, cell_keys(ti, tv, 16), 16).reshape(1, 4, 4, 8)
    assert not torch.equal(right, wrong)
    keys = cell_keys(torch.from_numpy(idx), torch.from_numpy(valid), 16)
    resorted = segment_max(torch.from_numpy(feats), keys, 16)
    assert torch.equal(resorted.reshape(1, 4, 4, 8), right)
