"""Int8 (w8a8) serving of the port (ops/quant.py, the int8 path of
models/layers.py::apply_seq, inference.py::calibrate_quant /
Predictor.quantize) against the JAX package's (lmsu_tpu/ops/quant.py,
ConvBNAct's quant_stats path, inference.py::calibrate_quant), on the CPU at
a small size (48^2 images, base_channels 8, widths 16, a 12 x 12 grid).

The primitives are held bit for bit: int8 values and scales of weights and
activations, and the int32 accumulators of the product. The model is held
layer for layer (the same set of quantised layers as JAX's quant_stats
paths, weighted and concat, with and without fused_inference; calibrated
absmax within rtol 1e-5) and end to end: with JAX's statistics carried
across (utils/weights.py::from_jax_quant_stats), the port's quantised logits
are within QUANT_PARITY of scale of JAX's (measured on the CPU: 3e-7 for
weighted with fused_inference, 2.8e-3 for concat without, where summation
order moves a few int8 values by one step), with equal argmax where the
float logits' margin exceeds 5e-2 of scale. tests/test_quant.py's own bar
holds for the port's quantised logits against its float ones. JAX runs under
jax.default_matmul_precision("highest"), compiled once per configuration.
"""

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
from lmsu_tpu.inference import calibrate_quant as jax_calibrate_quant
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.ops import quant as jq
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.inference import Predictor, calibrate_quant
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.layers import (ReLU6, apply_seq, calibration, conv_bn_act,
                                          quant_stats, set_quant_stats)
from lmsu_tpu_torch.ops import quant as tq
from lmsu_tpu_torch.utils.weights import convbn_names, from_jax_quant_stats

torch.set_num_threads(2)

IMG, NPTS, GRID = 48, 200, (12, 12)
# Port int8 logits against JAX int8 logits on the same weights and
# statistics, over the logits' scale: the two round the same f32 values, so
# only a float difference upstream of a layer (summation order) can move
# an int8 value by one step.
QUANT_PARITY = 2e-2


@pytest.fixture
def rng():
    return np.random.default_rng(16)


def configs(fusion: str = "weighted", fused: bool = False):
    """The same small model in both packages, the xla scatter (calibration
    and serving see the points in their own order)."""
    kw = dict(num_classes=2, fusion_type=fusion, fusion_out_channels=16,
              camera_fpn_channels=16)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID)
    jcfg = JModel(camera=JCam(base_channels=8, fused_inference=fused), lidar=JLidar(**lid),
                  **kw)
    pcfg = ModelConfig(camera=CameraEncoderConfig(base_channels=8, fused_inference=fused),
                       lidar=LidarEncoderConfig(**lid), **kw)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _state_dict(fusion: str):
    """Seeded port weights for `fusion` with randomised BN statistics
    (centred means), made once per fusion; JAX gets them through
    convert_torch_state_dict (no JAX init to compile)."""
    _, pcfg = configs(fusion)
    model = create_model(pcfg, seed=0)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.normal_(0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
        # Points in metres make LiDAR features tens of times the camera's:
        # scale the point MLP's last BN down so both streams move the logits.
        model.lidar_encoder.encoder.point_mlp[-2].weight.mul_(0.05)
    return model.state_dict()


def _inputs(seed: int = 0, n: int = 2):
    r = np.random.default_rng(seed)
    images = r.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)
    pts = r.normal(0, 25, (n, NPTS, 4)).astype(np.float32)
    pts[..., 2] = r.uniform(-5, 3, (n, NPTS))
    pts[..., 3] = r.uniform(0, 1, (n, NPTS))
    return images, pts


def _batches():
    return [{"image": i, "points": p} for i, p in (_inputs(0), _inputs(1))]


def _jax(fusion: str, fused: bool):
    jcfg, _ = configs(fusion, fused)
    return jax_create_model(jcfg), convert_torch_state_dict(_state_dict(fusion), jcfg)


@functools.lru_cache(maxsize=None)
def _jax_calibrated(fusion: str, fused: bool):
    """JAX's calibrate_quant over two batches and its int8 logits on the
    first, made once per configuration."""
    model, v = _jax(fusion, fused)
    with jax.default_matmul_precision("highest"):
        qv = jax_calibrate_quant(model, v, _batches())
        logits = jax.jit(lambda v, i, p: model.apply(v, i, p, train=False))(qv, *_inputs(0))
    return jax.tree_util.tree_map(np.asarray, qv["quant_stats"]), np.asarray(logits)


def _jax_stat_paths(fusion: str, fused: bool):
    """The paths of JAX's quant_stats collection, from an abstract
    calibration forward (jax.eval_shape: nothing compiles)."""
    model, v = _jax(fusion, fused)
    images, pts = _inputs(0)
    _, mut = jax.eval_shape(lambda v, i, p: model.apply(v, i, p, train=False,
                                                        mutable=["quant_stats"]), v, images, pts)
    return sorted(_paths(mut["quant_stats"]))


def _port(fusion: str, fused: bool) -> Predictor:
    _, pcfg = configs(fusion, fused)
    return Predictor(pcfg, _state_dict(fusion), device="cpu")


def _paths(tree, path=()):
    if "act_absmax" in tree:
        yield path
    for k, v in tree.items():
        if k != "act_absmax":
            yield from _paths(v, path + (k,))


# -- primitives ----------------------------------------------------------------


def _tie_weights(rng):
    """[48, 24] weights with an all-zero column and entries at exact .5
    steps of their column's scale (round half to even decides them)."""
    w = rng.normal(0, 0.3, (48, 24)).astype(np.float32)
    w[:, 3] = 0.0
    w[0, 5], w[1, 5] = 127.0, 2.5  # scale 1: 2.5 rounds to 2
    w[1, 6], w[2, 6] = -127.0, -3.5
    return w


def test_quantize_weights_and_acts_bit_exact(rng):
    w = _tie_weights(rng)
    jw, js = jq.quantize_weights(jnp.asarray(w))
    tw, ts = tq.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tw.dtype == torch.int8 and tw[1, 5] == 2 and tw[2, 6] == -4
    x = rng.normal(0, 2, (2, 6, 6, 48)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 200.0]  # ties at scale 1, one clipped value
    for absmax in (np.float32(127.0), np.float32(np.abs(x).max() * 0.7), np.float32(0.0)):
        jx, jsx = jq.quantize_acts(jnp.asarray(x), jnp.asarray(absmax))
        tx, tsx = tq.quantize_acts(torch.from_numpy(x), torch.tensor(absmax))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert tsx.numpy() == np.asarray(jsx)


def test_int8_pointwise_accumulators_and_outputs(rng):
    """The int32 accumulators equal JAX's dot_general of the same int8
    operands, by the plain product and by torch._int_mm with its padding
    (M < 17, K and N not multiples of 8); the outputs are within 1e-6 of
    scale of JAX's int8_pointwise."""
    x = rng.normal(0, 1, (3, 5, 47)).astype(np.float32)
    w = rng.normal(0, 0.2, (47, 21)).astype(np.float32)
    b = rng.normal(0, 0.1, (21,)).astype(np.float32)
    absmax = np.float32(np.abs(x).max())
    jx, _ = jq.quantize_acts(jnp.asarray(x), jnp.asarray(absmax))
    jw, _ = jq.quantize_weights(jnp.asarray(w))
    want = np.asarray(jax.lax.dot_general(jx.reshape(-1, 47), jw, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    tx, _ = tq.quantize_acts(torch.from_numpy(x).reshape(-1, 47), torch.tensor(absmax))
    tw, _ = tq.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.int8_matmul_plain(tx, tw).numpy(), want)
    np.testing.assert_array_equal(tq.int8_matmul(tx, tw.t().contiguous()).numpy(), want)
    np.testing.assert_array_equal(tq.int8_mm_padded(tx, tw.t().contiguous()).numpy(), want)
    got = tq.int8_pointwise(torch.from_numpy(x), torch.tensor(absmax), torch.from_numpy(w),
                            torch.from_numpy(b), torch.float32).numpy()
    ref = np.asarray(jq.int8_pointwise(jnp.asarray(x), jnp.asarray(absmax), jnp.asarray(w),
                                       jnp.asarray(b), jnp.float32))
    assert got.shape == (3, 5, 21)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tq.int8_matmul(torch.empty(20, 8, dtype=torch.int8, device="meta"),
                       torch.empty(8, 8, dtype=torch.int8, device="meta"))


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("fusion, fused, count", [
    ("weighted", False, 17), ("concat", False, 18), ("weighted", True, 8), ("concat", True, 9)])
def test_quantised_layers_match_jax(fusion, fused, count):
    """The port quantises exactly the layers JAX's calibration records
    (stage 1's project, stages 2-5's expand and project, the three FPN
    laterals, camera_fpn/post/pw, the fusion's projections and head
    block{1,2}/pw; the stages are not reached with fused_inference)."""
    pred = _port(fusion, fused)
    got = calibrate_quant(pred.model, _batches())
    names = convbn_names(pred.config)
    assert sorted(names[p][0] for p in _jax_stat_paths(fusion, fused)) == sorted(got)
    assert len(got) == count


@pytest.mark.parametrize("fusion, fused", [("weighted", True), ("concat", False)])
def test_quantised_absmax_and_logits_match_jax(fusion, fused):
    """The port's calibrated absmax is JAX's within rtol 1e-5. With JAX's
    statistics carried across, the port's int8 logits are within
    QUANT_PARITY of scale of JAX's int8 logits, with equal argmax where the
    float logits are decisive (margin > 5e-2 of scale)."""
    jstats, jquant = _jax_calibrated(fusion, fused)
    pred = _port(fusion, fused)
    images, pts = _inputs(0)
    flt = pred(images, pts).numpy()
    got = calibrate_quant(pred.model, _batches())
    want = from_jax_quant_stats(jstats, pred.config)
    assert sorted(want) == sorted(got)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].item(), v.item(), rtol=1e-5, err_msg=name)
    set_quant_stats(pred.model, want)
    q = pred(images, pts).numpy()
    err = np.abs(q - jquant).max() / np.abs(jquant).max()
    assert err <= QUANT_PARITY, err
    assert np.abs(q - flt).max() > 0  # the int8 path ran
    scale = np.abs(flt).max()
    decisive = np.abs(flt[..., 1] - flt[..., 0]) > 5e-2 * scale
    assert decisive.sum() > 0
    np.testing.assert_array_equal(q.argmax(-1)[decisive], jquant.argmax(-1)[decisive])


def test_port_quantised_vs_float_meets_jax_bar(rng):
    """tests/test_quant.py:113-131's bar on the port alone: int8 logits
    within 0.15 of scale of the float ones, and > 97% argmax agreement where
    the float logits' margin exceeds 0.1 of scale; predict_mask runs on the
    int8 path; a second calibration starts afresh."""
    pred = _port("weighted", True)
    images, pts = _inputs(2)
    ref = pred(images, pts).numpy()
    pred.quantize([(images, pts)])
    first = quant_stats(pred.model)
    got = pred(images, pts).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.15 * scale
    decisive = np.abs(ref[..., 1] - ref[..., 0]) > 0.1 * scale
    assert decisive.sum() > 0
    assert (got.argmax(-1) == ref.argmax(-1))[decisive].mean() > 0.97
    assert pred.predict_mask(images[0], pts[0]).shape == GRID
    other = (_inputs(3)[0], pts)
    pred.quantize([other])
    fresh = _port("weighted", True)
    fresh.quantize([other])
    assert quant_stats(pred.model) == quant_stats(fresh.model) != first


def test_calibrate_quant_needs_a_batch():
    pred = _port("weighted", True)
    pred.quantize([_inputs(0)])
    before = quant_stats(pred.model)
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_quant(pred.model, [])
    assert quant_stats(pred.model) == before


def _block(cin=24, cout=16, k=1, groups=1):
    r = torch.Generator().manual_seed(0)
    seq = torch.nn.Sequential(*conv_bn_act(cin, cout, k, groups=groups, act=ReLU6()))
    with torch.no_grad():
        seq[0].weight.normal_(0, 0.3, generator=r)
        seq[1].running_mean.normal_(0, 0.2, generator=r)
        seq[1].running_var.uniform_(0.5, 2.0, generator=r)
    return seq


def test_train_path_ignores_stats():
    """A calibrated conv's train-mode forward (and its gradients and BN
    running statistics) is the uncalibrated one's, bit for bit; in eval it
    takes the int8 path."""
    x = torch.randn(2, 24, 8, 8, generator=torch.Generator().manual_seed(1))
    plain, quant = _block(), _block()
    quant.eval()
    with torch.no_grad(), calibration():
        apply_seq(quant, x)
    assert quant[0].act_absmax == x.abs().max()
    outs = []
    for seq in (plain, quant):
        seq.train()
        xi = x.clone().requires_grad_(True)
        y = apply_seq(seq, xi)
        y.square().sum().backward()
        outs.append((y, xi.grad, seq[0].weight.grad, seq[1].running_mean, seq[1].running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    quant.eval()
    plain.eval()
    with torch.no_grad():
        q, f = apply_seq(quant, x), apply_seq(plain, x)
    assert not torch.equal(q, f) and (q - f).abs().max() < 0.05 * f.abs().max()


@pytest.mark.parametrize("k, groups", [(3, 1), (1, 24), (3, 24)])
def test_grouped_and_3x3_convs_are_never_calibrated(k, groups):
    seq = _block(24, 24, k, groups).eval()
    with torch.no_grad(), calibration():
        apply_seq(seq, torch.randn(1, 24, 8, 8))
    assert getattr(seq[0], "act_absmax", None) is None


def test_jax_stats_on_an_unknown_layer_are_refused():
    _, pcfg = configs("weighted")
    with pytest.raises(KeyError, match="no ConvBNAct"):
        from_jax_quant_stats({"fusion": {"attention": {"act_absmax": np.float32(1)}}}, pcfg)
    with pytest.raises(KeyError, match="no conv named"):
        set_quant_stats(_port("weighted", True).model, {"fusion.attention.1": 1.0})


def test_quantised_bf16_runs_and_tracks_f32():
    """bf16 compute: the int8 layers dequantise to bf16, and the int8
    logits move from f32 to bf16 by no more than the float model's own
    bf16-vs-f32 gap plus the f32 int8 error (a bf16 rounding upstream of a
    layer moves some of its int8 values by one step)."""
    _, pcfg = configs("weighted", True)
    p32 = _port("weighted", True)
    p16 = Predictor(dataclasses.replace(pcfg, compute_dtype=torch.bfloat16),
                    _state_dict("weighted"), device="cpu")
    images, pts = _inputs(0)
    f32 = p32(images, pts).numpy()
    gap = np.abs(p16(images, pts).float().numpy() - f32).max()
    p32.quantize([(images, pts)])
    set_quant_stats(p16.model, quant_stats(p32.model))
    q16, q32 = p16(images, pts), p32(images, pts).numpy()
    assert q16.dtype == torch.bfloat16
    assert np.abs(q16.float().numpy() - q32).max() <= gap + np.abs(q32 - f32).max()
