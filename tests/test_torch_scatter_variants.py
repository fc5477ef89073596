"""The scatter family against the JAX package, on the CPU: the flat
chunk-table sorted forward (its table and its plain version), the XLA-only
routes "sorted" and "xla_fastbwd" with their shared dense VJP, and the
LiDAR encoder under each of the five scatter_impl values and use_pallas.
JAX's Pallas kernels run in interpret mode; `_FWD_FLAT` is flipped in both
packages with monkeypatch. Forwards bit for bit, gradients at atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jax_init, jax_jit

import lmsu_tpu.ops.scatter_sorted_pallas as jsp
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.models.lidar_encoder import SpatialLiDAREncoder as JEncoder
from lmsu_tpu.ops import scatter as jscatter
from lmsu_tpu.ops.scatter_sorted_pallas import sort_points_by_bev_cell as jax_sort_points
from lmsu_tpu_torch.config import LidarEncoderConfig
from lmsu_tpu_torch.models.lidar_encoder import SpatialLiDAREncoder
from lmsu_tpu_torch.ops import scatter as pscatter
from lmsu_tpu_torch.ops import scatter_sorted as pss

torch.set_num_threads(2)

PC = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _sort(feats, idx, valid, hw):
    order = np.argsort(np.where(valid, idx, hw), axis=-1, kind="stable")
    return (np.take_along_axis(feats, order[..., None], 1), np.take_along_axis(idx, order, 1),
            np.take_along_axis(valid, order, 1))


def _data(rng, B, N, C, grid, invalid_frac=0.3, run=None, negative=False):
    """Coarse features (ties), invalid points, optionally a `run` = (start,
    stop) of points of cloud 0 put in one cell; unsorted."""
    hw = grid[0] * grid[1]
    feats = np.round(rng.normal(0, 1, (B, N, C)) * 2).astype(np.float32) / 2
    if negative:
        feats = -np.abs(feats) - 0.5
    idx = rng.integers(0, hw, (B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) >= invalid_frac
    if run is not None:
        idx[0, run[0]:run[1]] = idx[0, run[0]]
        valid[0, run[0]:run[1]] = True
    return feats, idx, valid


def _dt(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)


@pytest.mark.parametrize("grid", [(64, 64), (20, 20)], ids=["64x64", "20x20"])
@pytest.mark.parametrize("cw", [64, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunk_table_equals_jax(rng, dtype, cw, grid):
    """chunk_table (and the starts and padded length of flat_prep) against
    _prep / _chunk_table, integer for integer, padding slots included."""
    hw = grid[0] * grid[1]
    feats, idx, valid = _sort(*_data(rng, 2, 700, 4, grid, run=(100, 400)), hw)
    jdt, tdt = _dt(dtype)
    _, feat_p, j_starts, j_ntiles = jsp._prep(jnp.asarray(feats, jdt), jnp.asarray(idx),
                                              jnp.asarray(valid), hw)
    j_off, j_tile, j_S = jsp._chunk_table(j_starts, j_ntiles, feat_p.shape[1],
                                          jsp._align(jdt), cw)
    keys = pss.cell_keys(torch.from_numpy(idx), torch.from_numpy(valid), hw)
    starts, NP, ntiles = pss.flat_prep(keys, hw)
    assert (NP, ntiles) == (feat_p.shape[1], j_ntiles)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    off, tile, S = pss.chunk_table(starts, ntiles, NP, pss._align(tdt), cw)
    assert S == j_S and off.dtype == tile.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(j_off))
    np.testing.assert_array_equal(tile.numpy(), np.asarray(j_tile))
    assert (off == NP - cw).any(), "no padding slot"


@pytest.mark.parametrize("cw", [64, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flat_forward_equals_jax(rng, monkeypatch, dtype, cw):
    """segment_max_flat_plain, through bev_scatter_max_sorted_pallas with
    `_FWD_FLAT` set, against the JAX flat kernel, on a 100-point run that
    straddles window boundaries: forward exact and equal to the per-tile
    forward (K1's plain version); the gradient (K5's plain version) at 1e-6."""
    grid, hw = (6, 6), 36
    feats, idx, valid = _sort(*_data(rng, 2, 500, 8, grid, run=(100, 200)), hw)
    for mod in (jsp, pss):
        monkeypatch.setattr(mod, "_FWD_FLAT", True)
        monkeypatch.setattr(mod, "_CW_FWD", cw)
    jdt, tdt = _dt(dtype)
    ji, jv = jnp.asarray(idx), jnp.asarray(valid)
    jf = jnp.asarray(feats, jdt)

    def ref(f):
        out = jsp.bev_scatter_max_sorted_pallas(f, ji, jv, grid).astype(jnp.float32)
        return out, jax.grad(lambda f: jnp.sum(jsp.bev_scatter_max_sorted_pallas(
            f, ji, jv, grid).astype(jnp.float32) ** 2))(f).astype(jnp.float32)

    want, want_g = (np.asarray(a) for a in jax_jit(ref)(jf))
    tf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    out = pss.bev_scatter_max_sorted_pallas(tf, torch.from_numpy(idx), torch.from_numpy(valid),
                                            grid)
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    keys = pss.cell_keys(torch.from_numpy(idx), torch.from_numpy(valid), hw)
    k1 = pss.segment_max_plain(tf.detach(), keys, hw).reshape(out.shape)
    assert torch.equal(out.detach(), k1)
    (out.float() ** 2).sum().backward()
    np.testing.assert_allclose(tf.grad.float().numpy(), want_g, atol=1e-6, rtol=0)


VARIANT_CASES = {
    "ties_and_invalid": dict(B=2, N=300, C=8, grid=(8, 8)),
    "long_run": dict(B=1, N=400, C=4, grid=(6, 10), run=(50, 350)),
    "all_negative": dict(B=1, N=64, C=8, grid=(4, 4), negative=True),
    "all_invalid": dict(B=1, N=64, C=8, grid=(4, 4), invalid_frac=1.1),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(VARIANT_CASES))
@pytest.mark.parametrize("impl", ["sorted", "xla_fastbwd"])
def test_xla_routes_equal_jax(rng, impl, case, dtype):
    """bev_scatter_max_sorted ("sorted", points in any order) and
    bev_scatter_max_fastbwd ("xla_fastbwd") against their JAX functions."""
    kw = dict(VARIANT_CASES[case])
    grid = kw["grid"]
    feats, idx, valid = _data(rng, **kw)
    jfn, pfn = {"sorted": (jscatter.bev_scatter_max_sorted, pscatter.bev_scatter_max_sorted),
                "xla_fastbwd": (jscatter.bev_scatter_max_fastbwd,
                                pscatter.bev_scatter_max_fastbwd)}[impl]
    jdt, tdt = _dt(dtype)
    ji, jv = jnp.asarray(idx), jnp.asarray(valid)
    jf = jnp.asarray(feats, jdt)
    fwd = jax.jit(lambda f: jfn(f, ji, jv, grid).astype(jnp.float32))
    want = np.asarray(fwd(jf))
    want_g = np.asarray(jax.jit(jax.grad(lambda f: jnp.sum(fwd(f) ** 2)))(jf)
                        .astype(jnp.float32))
    tf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    out = pfn(tf, torch.from_numpy(idx), torch.from_numpy(valid), grid)
    assert out.dtype == tdt and out.shape == (kw["B"], *grid, kw["C"])
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    (out.float() ** 2).sum().backward()
    np.testing.assert_allclose(tf.grad.float().numpy(), want_g, atol=1e-6, rtol=0)


def test_dense_vjp_and_voxelize_max_equal_jax(rng):
    """scatter_max_dense_bwd on a random cotangent, and bev_voxelize_max on
    points (boundary and out-of-range ones among them), against JAX."""
    grid = (8, 8)
    feats, idx, valid = _data(rng, 2, 300, 8, grid, run=(10, 60))
    out = pscatter.bev_scatter_max(*(torch.from_numpy(a) for a in (feats, idx, valid)), grid)
    g = rng.normal(0, 1, out.shape).astype(np.float32)
    want = jscatter._scatter_max_dense_bwd(jnp.asarray(feats), jnp.asarray(idx),
                                           jnp.asarray(valid), jnp.asarray(out.numpy()),
                                           jnp.asarray(g), grid)
    got = pscatter.scatter_max_dense_bwd(*(torch.from_numpy(a) for a in (feats, idx, valid)),
                                         out, torch.from_numpy(g), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)

    pts = rng.normal(0, 40, (2, 300, 4)).astype(np.float32)
    pts[:, :20, 0] = 50.0
    pv = rng.uniform(size=(2, 300)) > 0.2
    want = jscatter.bev_voxelize_max(jnp.asarray(pts), jnp.asarray(feats), grid, PC,
                                     jnp.asarray(pv))
    got = pscatter.bev_voxelize_max(torch.from_numpy(pts), torch.from_numpy(feats), grid, PC,
                                    torch.from_numpy(pv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoder_state(variables, n_layers):
    """The JAX encoder's variables as the port encoder's state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for i in range(n_layers):
        sd[f"point_mlp.{3 * i}.weight"] = torch.from_numpy(
            np.asarray(p[f"mlp{i}"]["kernel"]).T.copy())[..., None]
        sd[f"point_mlp.{3 * i}.bias"] = torch.tensor(np.asarray(p[f"mlp{i}"]["bias"]))
        bn = f"point_mlp.{3 * i + 1}"
        sd[f"{bn}.weight"] = torch.tensor(np.asarray(p[f"bn{i}"]["scale"]))
        sd[f"{bn}.bias"] = torch.tensor(np.asarray(p[f"bn{i}"]["bias"]))
        sd[f"{bn}.running_mean"] = torch.tensor(np.asarray(s[f"bn{i}"]["mean"]))
        sd[f"{bn}.running_var"] = torch.tensor(np.asarray(s[f"bn{i}"]["var"]))
    return sd


ENCODER_ROUTES = {
    "xla": dict(scatter_impl="xla"),
    "xla_fastbwd": dict(scatter_impl="xla_fastbwd"),
    "sorted": dict(scatter_impl="sorted"),
    "pallas": dict(scatter_impl="pallas"),
    "use_pallas": dict(scatter_impl="xla", use_pallas=True),
    "sorted_pallas": dict(scatter_impl="sorted_pallas"),
    "sorted_pallas_flat": dict(scatter_impl="sorted_pallas"),
}


@pytest.mark.parametrize("route", list(ENCODER_ROUTES))
def test_encoder_scatter_routes_equal_jax(rng, monkeypatch, route):
    """SpatialLiDAREncoder in eval mode on shared weights: each route of the
    port against the same route of the JAX package (sorted_pallas on points
    sorted by cell, the other routes on points in their own order; the
    padded points are valid and pile up in the centre cell)."""
    kw = dict(grid_size=(8, 8), mlp_dims=(8, 16), feature_dim=8)
    jcfg = JLidar(**kw, **ENCODER_ROUTES[route])
    pcfg = LidarEncoderConfig(**kw, **ENCODER_ROUTES[route])
    if route == "sorted_pallas_flat":
        for mod in (jsp, pss):
            monkeypatch.setattr(mod, "_FWD_FLAT", True)
    pts = rng.normal(0, 30, (2, 240, 4)).astype(np.float32)
    pts[:, 200:] = 0.0
    pv = rng.uniform(size=(2, 240)) > 0.1
    if route.startswith("sorted_pallas"):
        j_pts, j_pv = jax_sort_points(jnp.asarray(pts), (8, 8), PC, jnp.asarray(pv))
        pts, pv = np.array(j_pts), np.array(j_pv)
    enc = JEncoder(jcfg)
    variables = jax.device_get(jax_init(enc, jax.random.PRNGKey(0), jnp.asarray(pts)))
    r = np.random.default_rng(5)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p, m: enc.apply(v, p, point_valid=m))(
            variables, jnp.asarray(pts), jnp.asarray(pv)))
    port = SpatialLiDAREncoder(pcfg).eval()
    port.load_state_dict(_encoder_state(variables, 3), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(pts), torch.from_numpy(pv)).numpy()
    assert got.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_unknown_scatter_impl_raises():
    enc = SpatialLiDAREncoder(dataclasses.replace(
        LidarEncoderConfig(grid_size=(4, 4), mlp_dims=(4,), feature_dim=4), scatter_impl="x"))
    with pytest.raises(ValueError, match="Unknown scatter_impl"):
        enc.eval()(torch.zeros(1, 8, 4))
