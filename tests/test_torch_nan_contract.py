"""The NaN contract of the port's plain versions against the JAX package on
the CPU: where a reference max or clip meets a NaN, the result is NaN, and
the NaN stays where the reference puts it.

The contract is the JAX package's `xla` scatter route
(lmsu_tpu/ops/scatter.py::bev_scatter_max): a cell holding a NaN of either
sign is NaN, and no other cell is. The plain versions of the sorted
forwards (K1's segment_max_plain, K4's segment_max_flat_plain), of the
unsorted one (K6's scatter_max_plain) and the port's own `xla` route must
give NaN in exactly those cells and agree with it bit for bit elsewhere.
relu6 of ops/ir_fused.py, the fused block's plain inference and the fusion
gate's plain version must keep NaN where the JAX package's `_relu6`,
`fused_ir_infer` and `weighted_fusion_gate` keep it (Pallas in interpret
mode on the CPU). The kernels are held to these plain versions on NaN
inputs on the card (chip_smoke.py: check_nan_scatter, check_nan_dense)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.models.layers import InvertedResidual as JaxIR
from lmsu_tpu.ops import ir_fused as jax_irf
from lmsu_tpu.ops.fusion_pallas import weighted_fusion_gate
from lmsu_tpu.ops.scatter import bev_scatter_max as jax_bev_scatter_max
from lmsu_tpu_torch.ops import ir_fused as irf
from lmsu_tpu_torch.ops import scatter_sorted as ss
from lmsu_tpu_torch.ops import voxelize as vx
from lmsu_tpu_torch.ops.fusion_gate import fusion_gate_plain
from lmsu_tpu_torch.ops.scatter import bev_scatter_max

torch.set_num_threads(2)

H = W = 12
HW = H * W


def nan_cloud(rng, B=2, N=400, C=6, run=40):
    """Sorted keys (a twelfth invalid, one cell of `run` points an image),
    features in quarters with NaN of both signs: scattered, at the first
    and at the last point of the long run, and one NaN on an invalid
    point (it must reach no cell)."""
    keys = rng.integers(0, HW, (B, N))
    keys[:, :run] = 50
    keys[:, -N // 12:] = HW
    keys = np.sort(keys, axis=1)
    f = (np.round(rng.normal(0, 1, (B, N, C)) * 4) / 4).astype(np.float32)
    hit = rng.random((B, N, C)) < 0.01
    f[hit] = np.where(rng.random(int(hit.sum())) < 0.5, np.float32(np.nan),
                      -np.float32(np.nan))
    for b in range(B):
        span = np.flatnonzero(keys[b] == 50)
        f[b, span[0], 1] = np.nan
        f[b, span[-1], 2] = -np.float32(np.nan)
        f[b, -1, 0] = np.nan  # an invalid point
    return f, keys.astype(np.int32)


def jax_reference(f, keys):
    valid = keys < HW
    out = jax_bev_scatter_max(jnp.asarray(f), jnp.asarray(np.minimum(keys, HW - 1)),
                              jnp.asarray(valid), (H, W))
    return np.asarray(out.astype(jnp.float32)).reshape(f.shape[0], HW, f.shape[2])


def nan_cells(f, keys):
    """[B, HW, C]: the cells that hold a NaN of a valid point."""
    B, N, C = f.shape
    want = np.zeros((B, HW, C), bool)
    for b in range(B):
        for p in range(N):
            if keys[b, p] < HW:
                want[b, keys[b, p]] |= np.isnan(f[b, p])
    return want


ROUTES = {
    "segment_max_plain": lambda f, k: ss.segment_max_plain(f, k, HW),
    "segment_max_flat_plain": lambda f, k: ss.segment_max_flat_plain(f, k, HW),
    "scatter_max_plain": lambda f, k: vx.scatter_max_plain(f, k, HW),
    "xla": lambda f, k: bev_scatter_max(f, k.clamp(max=HW - 1).long(), k < HW,
                                        (H, W)).reshape(f.shape[0], HW, f.shape[2]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scatter_plain_versions_keep_nan_in_its_cell(route, dtype):
    rng = np.random.default_rng(7)
    f, keys = nan_cloud(rng)
    ft = torch.from_numpy(f).to(dtype)
    kt = torch.from_numpy(keys)
    if route == "scatter_max_plain":  # K6 takes points in any order
        perm = torch.from_numpy(rng.permutation(f.shape[1]))
        ft, kt = ft[:, perm], kt[:, perm]
    got = ROUTES[route](ft, kt).float().numpy()
    want = jax_reference(ft.float().numpy(), kt.numpy())
    cells = nan_cells(f, keys)
    assert cells.any() and not cells.all()
    assert (np.isnan(want) == cells).all()  # the contract: the NaN stays in its cell
    assert (np.isnan(got) == cells).all()
    np.testing.assert_array_equal(got[~cells], want[~cells])


def test_relu6_keeps_nan_as_jax():
    x = np.array([np.nan, -np.nan, -1.0, -0.0, 0.0, 3.0, 6.0, 7.0, np.inf, -np.inf],
                 np.float32)
    got = irf._relu6(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_irf._relu6(jnp.asarray(x)))
    assert np.isnan(got[:2]).all() and np.isnan(want[:2]).all()
    np.testing.assert_array_equal(got[2:], want[2:])


@pytest.mark.parametrize("shape", [(2, 6, 6, 32), (1, 5, 7, 40)])
def test_gate_plain_keeps_nan_as_jax(shape):
    """A NaN in one channel of a pixel makes that pixel's gate NaN (the 1x1
    product mixes its channels, the ReLU keeps NaN) and no other pixel's."""
    rng = np.random.default_rng(3)
    C = shape[-1]
    cam = rng.normal(0, 1, shape).astype(np.float32)
    lid = rng.normal(0, 1, shape).astype(np.float32)
    cam[0, 1, 2, 3] = np.nan
    lid[-1, -1, 0, C - 1] = -np.float32(np.nan)
    w1 = rng.normal(0, 0.1, (1, 1, 2 * C, C)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (C,)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (1, 1, C, 2)).astype(np.float32)
    b2 = rng.normal(0, 0.2, (2,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(weighted_fusion_gate(*(jnp.asarray(a) for a in
                                                 (cam, lid, w1, b1, w2, b2))))
    t = torch.from_numpy
    got = fusion_gate_plain(t(cam), t(lid), t(w1.transpose(3, 2, 0, 1).copy()), t(b1),
                            t(w2.transpose(3, 2, 0, 1).copy()), t(b2)).numpy()
    pixels = np.isnan(cam).any(-1) | np.isnan(lid).any(-1)
    assert (np.isnan(want) == pixels[..., None]).all()
    assert (np.isnan(got) == np.isnan(want)).all()
    np.testing.assert_allclose(got[~pixels], want[~pixels], atol=1e-5)


@pytest.mark.parametrize("variant", [(8, 16, 2, 6), (16, 16, 1, 6), (8, 8, 1, 1)])
def test_fused_block_plain_keeps_nan_as_jax(variant):
    """The fused InvertedResidual's plain inference (relu6 after the expand
    and the depthwise) keeps NaN where the JAX package's fused_ir_infer
    does: the NaN pixel's 3x3 neighbourhood (at the stride), all channels."""
    Cin, Cout, stride, exp = variant
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 10, 10, Cin)).astype(np.float32)
    mod = JaxIR(Cout, (stride, stride), expansion_ratio=exp)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(0, 1, a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    jp = jax_irf.params_from_variables(v)
    x[0, 4, 5, 1] = np.nan
    x[1, 0, 0, 0] = -np.float32(np.nan)
    want = np.asarray(jax_irf.fused_ir_infer(jnp.asarray(x), jp, stride=stride))
    got = irf.fused_ir_infer(torch.from_numpy(x), irf.IRParams(
        *(None if a is None else torch.from_numpy(np.array(a, np.float32)) for a in jp)),
        stride=stride).numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    assert (np.isnan(got) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-5)
