"""The port's complete model against the JAX package's: parameter count,
weights round-tripped through both converters, and logits on shared
weights and inputs with the three kernel opt-ins off and on (CPU: the
port's kernels run their plain versions, the JAX Pallas kernels run in
interpret mode)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.config import (CameraEncoderConfig, LidarEncoderConfig, ModelConfig,
                                   teacher_config)
from lmsu_tpu_torch.data.rasterize import make_point_sorter
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.models import count_parameters, create_model
from lmsu_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

IMG, NPTS, GRID = 64, 400, (16, 16)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def jax_jit(fn):
    """fn under jax.jit, compiled with XLA's excess precision off: bf16 work
    then rounds each op's output to bf16 as the op-by-op run does (the same
    numbers), in one compilation instead of one per op."""
    def call(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    return call


def jax_init(module, key, *args, **kwargs):
    """module.init(key, *args, **kwargs) under jax.jit: one compiled program
    instead of one compilation per op, the same initialisers and keys."""
    return jax.jit(lambda k: module.init(k, *args, **kwargs))(key)


def jax_init_model(model, seed):
    """The JAX package's init_model(model, PRNGKey(seed)) as numpy, under
    jax.jit and made once per process for each configuration. The variables
    do not depend on the inputs' sizes, nor on the kernel and compute
    options (the scatter, the fused opt-ins, the compute dtype), which
    select paths (flax draws each variable from its module path): so they
    are made at 64^2 images and 16 points, from the configuration without
    those options. Each call returns its own dicts over shared read-only
    arrays."""
    cfg = model.config
    plain = dataclasses.replace(
        cfg, use_pallas_fusion=False, compute_dtype=jnp.float32,
        camera=dataclasses.replace(cfg.camera, fused_inference=False, fused_train=False),
        lidar=dataclasses.replace(cfg.lidar, scatter_impl="xla", use_pallas=False))
    return jax.tree_util.tree_map(lambda a: a, _init_plain(plain, seed))


@functools.lru_cache(maxsize=None)
def _init_plain(cfg, seed):
    images = jnp.zeros((1, 64, 64, 3), jnp.float32)
    points = jnp.zeros((1, 16, cfg.lidar.input_dim), jnp.float32)
    v = jax_init(jax_create_model(cfg), jax.random.PRNGKey(seed), images, points, train=False)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    for a in jax.tree_util.tree_leaves(v):
        a.flags.writeable = False
    return v


def _configs(opt_ins: bool, scatter: str = ""):
    """The same small weighted-fusion model in both packages; the scatter is
    `scatter`, else "sorted_pallas" with the kernel opt-ins and "xla"
    without."""
    kw = dict(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
              camera_fpn_channels=32, use_pallas_fusion=opt_ins)
    lid = dict(feature_dim=32, mlp_dims=(16, 32), grid_size=GRID,
               scatter_impl=scatter or ("sorted_pallas" if opt_ins else "xla"))
    jcfg = JModel(camera=JCam(base_channels=8, fused_inference=opt_ins),
                  lidar=JLidar(**lid), **kw)
    pcfg = ModelConfig(camera=CameraEncoderConfig(base_channels=8, fused_inference=opt_ins),
                       lidar=LidarEncoderConfig(**lid), **kw)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def jax_variables():
    """JAX-initialised variables with randomised BN statistics (numpy):
    running means centred, N(0, 0.2), and variances U(0.5, 2.0), as
    chip_smoke.py::randomize_bn draws them. (Means drawn from the variances'
    law, U(0.5, 1.5), zero every ReLU of the head and leave constant logits.)"""
    jcfg, _ = _configs(False)
    r = np.random.default_rng(0)
    v = jax_init_model(jax_create_model(jcfg), 0)
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + r.normal(0, 0.05, a.shape).astype(np.float32), v["params"])

    def stat(path, a):
        if path[-1].key == "mean":
            return r.normal(0, 0.2, a.shape).astype(np.float32)
        return r.uniform(0.5, 2.0, a.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    return v


def assert_varies(logits):
    """Each image's map of each class varies over pixels (a fixture that
    zeroes the signal would compare constants)."""
    std = np.asarray(logits, np.float64).std(axis=(1, 2))
    assert std.min() > 1e-2 * max(1.0, np.abs(logits).max()), std


def _inputs(rng, jcfg, sort=True):
    images = rng.integers(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    pts = rng.normal(0, 30, (2, NPTS, 4)).astype(np.float32)
    pv = rng.uniform(size=(2, NPTS)) > 0.2
    if sort:
        # Sorted once on the host for both sides (the sorted kernels' contract).
        sorter = make_point_sorter(GRID, jcfg.lidar.point_cloud_range)
        rows = [sorter({"points": pts[i], "point_valid": pv[i]}) for i in range(2)]
        pts = np.stack([r["points"] for r in rows])
        pv = np.stack([r["point_valid"] for r in rows])
    return images, pts, pv


_LOGITS = {}


def _jax_logits(jcfg, variables, images, pts, pv):
    """JAX's eval logits as f32 numpy (the forward under jax_jit), made once
    per process for each configuration, set of variables and input."""
    key = (jcfg, id(variables), images.tobytes(), pts.tobytes(), pv.tobytes())
    if key not in _LOGITS:
        model = jax_create_model(jcfg)
        with jax.default_matmul_precision("highest"):
            logits = jax_jit(lambda v, i, p, m: model.apply(
                v, i, p, train=False, point_valid=m).astype(jnp.float32))(
                    variables, jnp.asarray(images), jnp.asarray(pts), jnp.asarray(pv))
        logits = np.array(logits)
        logits.flags.writeable = False
        _LOGITS[key] = (variables, logits)  # holds `variables`, so its id stays its own
    return _LOGITS[key][1]


def test_full_width_weighted_student_parameter_count():
    cfg = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128)
    assert count_parameters(create_model(cfg)) == 528_132


def test_unported_variants_are_refused():
    """What the port does not build: an unknown fusion_type, output_mode or
    LiDAR encoder_type is a ValueError, as in the JAX package
    (models/fusion.py:332, :342; lidar_encoder.py:178). Remat and the
    pillar encoder are ported: they build (tests/test_torch_remat.py,
    tests/test_torch_pointpillars.py)."""
    model = create_model(ModelConfig(camera=CameraEncoderConfig(remat=True),
                                     lidar=LidarEncoderConfig(encoder_type="pointpillars")))
    assert model.camera_encoder.config.remat
    assert type(model.lidar_encoder.encoder).__name__ == "PointPillarsLiDAREncoder"
    with pytest.raises(ValueError, match="Unknown encoder type"):
        create_model(ModelConfig(lidar=LidarEncoderConfig(encoder_type="voxelnet")))
    with pytest.raises(ValueError, match="fusion_type"):
        create_model(ModelConfig(fusion_type="attention"))
    with pytest.raises(ValueError, match="output_mode"):
        create_model(ModelConfig(output_mode="x8"))


def test_weights_round_trip_through_both_converters(jax_variables):
    jcfg, pcfg = _configs(False)
    sd = from_jax_variables(jax_variables, pcfg)
    create_model(pcfg).load_state_dict(sd, strict=True)
    back = convert_torch_state_dict(sd, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


@pytest.mark.parametrize("opt_ins, scatter", [(False, ""), (True, ""), (True, "pallas")],
                         ids=["plain_path", "kernel_path", "pallas"])
def test_logits_match_jax(jax_variables, rng, opt_ins, scatter):
    """With the "pallas" scatter the points stay in their order: neither
    package's Predictor sorts for it."""
    jcfg, pcfg = _configs(opt_ins, scatter)
    images, pts, pv = _inputs(rng, jcfg, sort=scatter != "pallas")
    want = _jax_logits(jcfg, jax_variables, images, pts, pv)
    assert_varies(want)
    pred = Predictor(pcfg, from_jax_variables(jax_variables, pcfg), device="cpu")
    assert (pred._sorter is not None) == (pcfg.lidar.scatter_impl == "sorted_pallas")
    got = pred(images, pts, pv)
    assert got.shape == (2, *GRID, 2) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    top2 = np.sort(want, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    assert not ((got.argmax(-1) != want.argmax(-1)) & (margin > 1e-3)).any()


def test_bf16_logits_match_jax_bf16(jax_variables, rng):
    """compute_dtype=bfloat16 on both sides, kernel opt-ins on. Limit, from
    JAX's own bf16-vs-f32 gap G on the same input: |port - JAX| <= 2 G (a
    triangle through the f32 logits, each bf16 path as far from them as
    JAX's is)."""
    jcfg, pcfg = _configs(True)
    images, pts, pv = _inputs(rng, jcfg)
    f32 = _jax_logits(jcfg, jax_variables, images, pts, pv)
    jcfg16 = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    want = _jax_logits(jcfg16, jax_variables, images, pts, pv)
    gap = np.abs(want - f32).max()
    assert_varies(want)
    assert 0 < gap < 0.1 * np.abs(f32).max()
    pred = Predictor(dataclasses.replace(pcfg, compute_dtype=torch.bfloat16),
                     from_jax_variables(jax_variables, pcfg), device="cpu")
    got = pred(images, pts, pv)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= 2 * gap


def test_bf16_compute_runs_and_tracks_f32(jax_variables, rng):
    """compute_dtype=bfloat16 keeps f32 parameters and returns bf16 logits
    close to the f32 model (bf16 has ~3 significant digits)."""
    _, pcfg = _configs(True)
    sd = from_jax_variables(jax_variables, pcfg)
    images = rng.integers(0, 256, (1, IMG, IMG, 3)).astype(np.uint8)
    pts = rng.normal(0, 30, (1, NPTS, 4)).astype(np.float32)
    f32 = Predictor(pcfg, sd, device="cpu")(images, pts)
    bf16_pred = Predictor(dataclasses.replace(pcfg, compute_dtype=torch.bfloat16), sd,
                          device="cpu")
    assert all(p.dtype == torch.float32 for p in bf16_pred.model.parameters())
    bf16 = bf16_pred(images, pts)
    assert bf16.dtype == torch.bfloat16
    scale = float(f32.abs().max())
    assert float((bf16.float() - f32).abs().max()) < 0.1 * max(1.0, scale)


def test_teacher_config_matches_jax():
    jcfg, pcfg = _configs(True)
    jt, pt = jax_teacher_config(jcfg, 2.0), teacher_config(pcfg, 2.0)
    for sub in ("camera", "lidar"):
        assert dataclasses.asdict(getattr(jt, sub)) == dataclasses.asdict(getattr(pt, sub))
    assert (jt.camera_fpn_channels, jt.fusion_out_channels) == \
        (pt.camera_fpn_channels, pt.fusion_out_channels)


def test_intermediates_taps(jax_variables, rng):
    """The KD tap contract of the reference forward: camera_feat,
    lidar_feat, pre_fusion, post_fusion, logits."""
    _, pcfg = _configs(True)
    model = create_model(pcfg).eval()
    model.load_state_dict(from_jax_variables(jax_variables, pcfg))
    images = torch.from_numpy(rng.uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(0, 30, (1, NPTS, 4)).astype(np.float32))
    pts = torch.from_numpy(make_point_sorter(GRID, pcfg.lidar.point_cloud_range)(
        {"points": pts[0].numpy()})["points"])[None]
    with torch.no_grad():
        logits, taps = model(images, pts, return_intermediates=True)
    assert set(taps) == {"camera_feat", "lidar_feat", "pre_fusion", "post_fusion", "logits"}
    assert taps["camera_feat"].shape == taps["lidar_feat"].shape == (1, 32, *GRID)
    assert torch.equal(taps["logits"], logits)
