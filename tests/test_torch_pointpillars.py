"""The port's PointPillars LiDAR encoder against the JAX package's, on the
CPU (JAX's Pallas scatters in interpret mode):

  * full-width parameter counts of the pillar models (weighted/128,
    minimal/128, concat/256) equal the JAX package's (counted from its
    variables' shapes, jax.eval_shape: no compilation) and the numbers of
    record;
  * weights carry from JAX to the port through from_jax_variables
    (`pfn{i}` / `bn{i}` -> `pfn.{3i}` / `.{3i + 1}`);
  * the encoder in eval mode under all five scatter routes and use_pallas,
    f32, within atol 1e-5 (the spatial encoder's bar in
    tests/test_torch_scatter_variants.py); in train mode its output and
    the BatchNorm running statistics after the step;
  * in bf16 the decorated point features (point, dx, dy, distance) that
    the first PFN layer reads equal JAX's bit for bit (both computed op by
    op, JAX eagerly), and the BEV map within 2x JAX's own bf16-vs-f32 gap;
  * the full pillar model's logits within atol 5e-4, argmax agreement
    where the margin exceeds 1e-3 (f32), and in bf16 within 2x JAX's gap;
  * the cell-centre decoration maps back to the point's own cell
    (tests/test_models.py:120's property, on the port's own features).
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jax_jit

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.models import count_parameters as jax_count_parameters
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.models.lidar_encoder import LiDAREncoder as JEncoder
from lmsu_tpu.ops.scatter_sorted_pallas import sort_points_by_bev_cell as jax_sort_points
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.models import count_parameters, create_model
from lmsu_tpu_torch.models import lidar_encoder as plidar
from lmsu_tpu_torch.ops.scatter import points_to_bev_indices
from lmsu_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

PC = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
GRID = (8, 8)
ENC = dict(encoder_type="pointpillars", grid_size=GRID, mlp_dims=(8, 16), feature_dim=16)


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _model_kw(fusion="weighted", channels=16):
    return dict(num_classes=2, fusion_type=fusion, fusion_out_channels=channels,
                camera_fpn_channels=16)


def _configs(**lidar):
    """The same small weighted pillar model in both packages."""
    lid = {**ENC, **lidar}
    return (JModel(camera=JCam(base_channels=4), lidar=JLidar(**lid), **_model_kw()),
            ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(**lid), **_model_kw()))


def to_jax_variables(state_dict, jcfg):
    """A port pillar model's state dict as JAX variables: the JAX converter
    knows the spatial encoder's `point_mlp` only, so the PFN goes through it
    under that name and its `mlp{i}` come back as `pfn{i}`."""
    sd = {k.replace("encoder.pfn.", "encoder.point_mlp."): v for k, v in state_dict.items()}
    v = jax.tree_util.tree_map(np.asarray, convert_torch_state_dict(sd, jcfg))
    enc = v["params"]["lidar_encoder"]["encoder"]
    for i in range(3):
        enc[f"pfn{i}"] = enc.pop(f"mlp{i}")
    return v


def randomized(model, seed):
    """`model` with its parameters moved by N(0, 0.05) and BN statistics
    drawn (means centred N(0, 0.2), variances U(0.5, 2)), so eval mode
    normalises with real statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + 1.5 * torch.rand(b.shape, generator=g))
    return model


def _points(rng, sort=False, B=2, N=240):
    pts = rng.normal(0, 30, (B, N, 4)).astype(np.float32)
    pts[:, 200:] = 0.0  # padding: valid, in the centre cell
    pv = rng.uniform(size=(B, N)) > 0.1
    if sort:
        j_pts, j_pv = jax_sort_points(jnp.asarray(pts), GRID, PC, jnp.asarray(pv))
        pts, pv = np.array(j_pts), np.array(j_pv)
    return pts, pv


def _encoder_pair(lidar_kw, seed=0):
    """(JAX encoder, its variables, port encoder) on shared weights."""
    jcfg, pcfg = _configs(**lidar_kw)
    model = randomized(create_model(pcfg, seed=seed), seed)
    v = to_jax_variables(model.state_dict(), jcfg)
    jv = {"params": v["params"]["lidar_encoder"], "batch_stats": v["batch_stats"]["lidar_encoder"]}
    port = plidar.LiDAREncoder(pcfg.lidar)
    port.load_state_dict({k[len("lidar_encoder."):]: t for k, t in model.state_dict().items()
                          if k.startswith("lidar_encoder.")}, strict=True)
    return JEncoder(jcfg.lidar), jv, port


@pytest.mark.parametrize("fusion, channels, want", [
    ("weighted", 128, 528_324), ("minimal", 128, 495_170), ("concat", 256, 573_634)])
def test_full_width_parameter_counts(fusion, channels, want):
    lid = dict(encoder_type="pointpillars")
    got = count_parameters(create_model(ModelConfig(
        num_classes=2, fusion_type=fusion, fusion_out_channels=channels,
        lidar=LidarEncoderConfig(**lid))))
    jm = jax_create_model(JModel(num_classes=2, fusion_type=fusion,
                                 fusion_out_channels=channels, lidar=JLidar(**lid)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            jnp.zeros((1, 16, 4)), train=False))
    assert got == jax_count_parameters(shapes["params"]) == want
    # The spatial model of the same widths has 3 x 64 fewer (the first
    # layer's 3 decoration inputs).
    assert want - count_parameters(create_model(ModelConfig(
        num_classes=2, fusion_type=fusion, fusion_out_channels=channels))) == 192


def test_weights_from_jax_and_unknown_type():
    jcfg, pcfg = _configs()
    sd = randomized(create_model(pcfg), 1).state_dict()
    back = from_jax_variables(to_jax_variables(sd, jcfg), pcfg)
    assert set(back) == set(sd)
    assert back["lidar_encoder.encoder.pfn.0.weight"].shape == (8, 7, 1)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="Unknown encoder type"):
        create_model(dataclasses.replace(
            pcfg, lidar=dataclasses.replace(pcfg.lidar, encoder_type="voxelnet")))


ROUTES = {"xla": dict(scatter_impl="xla"), "xla_fastbwd": dict(scatter_impl="xla_fastbwd"),
          "sorted": dict(scatter_impl="sorted"), "pallas": dict(scatter_impl="pallas"),
          "use_pallas": dict(scatter_impl="xla", use_pallas=True),
          "sorted_pallas": dict(scatter_impl="sorted_pallas")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_encoder_routes_match_jax(rng, route):
    """Eval mode, f32, on points sorted by cell for sorted_pallas and in
    their own order for the others."""
    jenc, jv, port = _encoder_pair(ROUTES[route])
    pts, pv = _points(rng, sort=route == "sorted_pallas")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p, m: jenc.apply(v, p, point_valid=m))(
            jv, jnp.asarray(pts), jnp.asarray(pv)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pts), torch.from_numpy(pv)).numpy()
    assert got.shape == (2, *GRID, 16) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_encoder_train_mode_and_running_stats(rng):
    """Train mode: the output from batch statistics over (B, N), and the
    running statistics after the step, flax's rule (momentum 0.9, biased
    variance)."""
    jenc, jv, port = _encoder_pair(ROUTES["xla"])
    pts, pv = _points(rng)
    with jax.default_matmul_precision("highest"):
        want, mut = jax.jit(lambda v, p, m: jenc.apply(v, p, train=True, point_valid=m,
                                                       mutable=["batch_stats"]))(
            jv, jnp.asarray(pts), jnp.asarray(pv))
    got = port.train()(torch.from_numpy(pts), torch.from_numpy(pv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = mut["batch_stats"]["encoder"]
    for i in range(3):
        bn = port.encoder.pfn[3 * i + 1]
        for ours, theirs in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            w = np.asarray(stats[f"bn{i}"][theirs])
            np.testing.assert_allclose(ours.numpy(), w, atol=1e-6 * max(1, np.abs(w).max()),
                                       rtol=1e-5)


def _pfn_inputs_port(port, pts, pv, dtype):
    """The decorated features the port's first PFN layer reads."""
    seen = []
    real = plidar.apply_seq

    def spy(seq, x):
        seen.append(x.transpose(1, 2).clone())
        return real(seq, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plidar, "apply_seq", spy)
        with torch.no_grad():
            out = port.eval()(torch.from_numpy(pts), torch.from_numpy(pv), dtype)
    return seen[0], out


def _pfn_inputs_jax(jenc, jv, pts, pv):
    """JAX's decorated features (the input of its Dense pfn0), eagerly, op by
    op, and its output."""
    seen = []

    def spy(next_fun, args, kwargs, context):
        if context.module.name == "pfn0" and context.method_name == "__call__":
            seen.append(np.asarray(args[0].astype(jnp.float32)))
        return next_fun(*args, **kwargs)
    with flax_nn.intercept_methods(spy):
        out = jenc.apply(jv, jnp.asarray(pts), point_valid=jnp.asarray(pv))
    return seen[0], out


def test_bf16_decoration_bit_exact_and_map_within_gap(rng):
    jenc, jv, port = _encoder_pair(ROUTES["xla"])
    jenc16 = JEncoder(jenc.config, dtype=jnp.bfloat16)
    pts, pv = _points(rng)
    want_feats, want = _pfn_inputs_jax(jenc16, jv, pts, pv)
    got_feats, got = _pfn_inputs_port(port, pts, pv, torch.bfloat16)
    assert got_feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_feats.float().numpy(), want_feats)
    with jax.default_matmul_precision("highest"):
        f32 = np.asarray(jax.jit(lambda v, p, m: jenc.apply(v, p, point_valid=m))(
            jv, jnp.asarray(pts), jnp.asarray(pv)))
    want = np.asarray(want.astype(jnp.float32))
    gap = np.abs(want - f32).max()
    assert 0 < gap < 0.1 * np.abs(f32).max()
    assert np.abs(got.float().numpy() - want).max() <= 2 * gap


def test_pillar_centre_maps_back_to_its_cell(rng):
    """x - dx (the centre the port decorates with) lies in the point's own
    cell at a 64 x 64 grid (the JAX package's property, test_models.py:120)."""
    cfg = LidarEncoderConfig(**{**ENC, "grid_size": (64, 64)})
    port = plidar.LiDAREncoder(cfg)
    pts = np.zeros((1, 2000, 4), np.float32)
    pts[..., :2] = rng.uniform(-49.9, 49.9, (1, 2000, 2))
    feats, _ = _pfn_inputs_port(port, pts, np.ones((1, 2000), bool), torch.float32)
    centres = torch.from_numpy(pts[..., :2]) - feats[..., 4:6]
    idx, valid = points_to_bev_indices(torch.from_numpy(pts[..., :2]), (64, 64), PC)
    idx2, valid2 = points_to_bev_indices(centres, (64, 64), PC)
    assert bool(valid.all()) and bool(valid2.all())
    assert torch.equal(idx, idx2)
    # The distance feature is the planar norm.
    np.testing.assert_allclose(feats[0, :, 6].numpy(), np.hypot(pts[0, :, 0], pts[0, :, 1]),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def model_pair():
    jcfg, pcfg = _configs()
    model = randomized(create_model(pcfg, seed=3), 3)
    return jcfg, pcfg, model, to_jax_variables(model.state_dict(), jcfg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_model_logits_match_jax(model_pair, rng, dtype):
    jcfg, pcfg, model, v = model_pair
    images = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    pts, pv = _points(rng)

    def jax_logits(cfg):
        m = jax_create_model(cfg)
        with jax.default_matmul_precision("highest"):
            return np.asarray(jax_jit(lambda v, i, p, k: m.apply(
                v, i, p, train=False, point_valid=k).astype(jnp.float32))(
                v, jnp.asarray(images), jnp.asarray(pts), jnp.asarray(pv)))
    f32 = jax_logits(jcfg)
    std = f32.std(axis=(1, 2))
    assert std.min() > 1e-2 * max(1.0, np.abs(f32).max())
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    port = create_model(dataclasses.replace(pcfg, compute_dtype=tdt))
    port.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images), torch.from_numpy(pts),
                          torch.from_numpy(pv))
    assert got.dtype == tdt and got.shape == (2, *GRID, 2)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, f32, atol=5e-4, rtol=1e-3)
        top2 = np.sort(f32, axis=-1)
        margin = top2[..., -1] - top2[..., -2]
        assert not ((got.argmax(-1) != f32.argmax(-1)) & (margin > 1e-3)).any()
    else:
        want = jax_logits(dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16))
        gap = np.abs(want - f32).max()
        assert 0 < gap < 0.1 * np.abs(f32).max()
        assert np.abs(got - want).max() <= 2 * gap
