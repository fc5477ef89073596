"""The concat, minimal and gated-sum fusions and the x4 head of the port
against the JAX package's, at tests/test_torch_model.py's small size
(64^2 images, base_channels 8, widths 32, concat to 48 channels, centred BN
means): exact full-width parameter counts, weights through both converters,
logits on the plain and the kernel path (the port's kernels run their plain
versions on the CPU, the JAX Pallas kernels run in interpret mode), concat
in bf16, one train-mode CE forward and backward (gradients and BatchNorm
running statistics), the KD tap widths, and one KD step of a concat
student. JAX runs under jax.default_matmul_precision("highest"); each
variant's JAX variables are built once for the module.

gated_sum has no reference analog, so the JAX package's torch converter
(`convert_torch_state_dict`) names no gate for it: its weights go through
`from_jax_variables` only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_kd_step as kd
import torch
from test_torch_model import GRID, _inputs, _jax_logits, assert_varies, jax_init_model

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.ops.losses import weighted_cross_entropy as jax_wce
from lmsu_tpu.training.distill import _tap_channels
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.config import (CameraEncoderConfig, LidarEncoderConfig, ModelConfig,
                                   teacher_config)
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.models import count_parameters, create_model
from lmsu_tpu_torch.ops.losses import weighted_cross_entropy
from lmsu_tpu_torch.training.distill import tap_channels
from lmsu_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

# (fusion_type, output_mode) of each small model under test.
VARIANTS = {"concat": ("concat", "same"), "minimal": ("minimal", "same"),
            "gated_sum": ("gated_sum", "same"), "minimal_x4": ("minimal", "x4")}
CLASS_WEIGHTS = (0.4, 3.5)


@pytest.fixture
def rng():
    return np.random.default_rng(12)


def _configs(variant: str, opt_ins: bool = False, dtype=None):
    """The small model of `variant` in both packages, with the kernel
    opt-ins (sorted_pallas, fused_inference, use_pallas_fusion, which acts
    on the weighted fusion only) or without them (the xla scatter)."""
    fusion, head = VARIANTS[variant]
    kw = dict(num_classes=2, fusion_type=fusion, output_mode=head,
              fusion_out_channels=48 if fusion == "concat" else 32,
              camera_fpn_channels=32, use_pallas_fusion=opt_ins)
    lid = dict(feature_dim=32, mlp_dims=(16, 32), grid_size=GRID,
               scatter_impl="sorted_pallas" if opt_ins else "xla")
    jcfg = JModel(camera=JCam(base_channels=8, fused_inference=opt_ins),
                  lidar=JLidar(**lid), compute_dtype=dtype[0] if dtype else jnp.float32, **kw)
    pcfg = ModelConfig(camera=CameraEncoderConfig(base_channels=8, fused_inference=opt_ins),
                       lidar=LidarEncoderConfig(**lid),
                       compute_dtype=dtype[1] if dtype else torch.float32, **kw)
    return jcfg, pcfg


def _jax_variables(variant: str):
    """JAX-initialised variables (numpy) moved by N(0, 0.05), with running
    means N(0, 0.2) and variances U(0.5, 2) (test_torch_model.py's fixture)."""
    jcfg, _ = _configs(variant)
    r = np.random.default_rng(sorted(VARIANTS).index(variant))
    v = jax_init_model(jax_create_model(jcfg), 0)
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + r.normal(0, 0.05, a.shape).astype(np.float32), v["params"])

    def stat(path, a):
        if path[-1].key == "mean":
            return r.normal(0, 0.2, a.shape).astype(np.float32)
        return r.uniform(0.5, 2.0, a.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def jax_variables():
    """variant -> its JAX variables, made at first use."""
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _jax_variables(variant)
        return cache[variant]
    return get


FULL_WIDTH = [  # (fusion_type, fusion_out_channels, output_mode, parameters)
    ("concat", 256, "same", 573_442), ("minimal", 128, "same", 494_978),
    ("gated_sum", 128, "same", 528_132), ("minimal", 128, "x4", 630_274),
    ("concat", 256, "x4", 830_210)]


@pytest.mark.parametrize("fusion, channels, head, count", FULL_WIDTH,
                         ids=[f"{f}{c}_{h}" for f, c, h, _ in FULL_WIDTH])
def test_full_width_parameter_counts(fusion, channels, head, count):
    """The JAX package's init_model counts (tests/test_models.py:150-151 and
    BASELINE.md for the ablation's three); they do not depend on image size."""
    cfg = ModelConfig(num_classes=2, fusion_type=fusion, fusion_out_channels=channels,
                      output_mode=head)
    assert count_parameters(create_model(cfg)) == count


def test_default_model_is_concat_256():
    model = create_model()
    assert (model.config.fusion_type, model.config.fusion_out_channels) == ("concat", 256)
    assert count_parameters(model) == 573_442


@pytest.mark.parametrize("variant", ["concat", "minimal", "minimal_x4"])
def test_weights_round_trip_through_both_converters(jax_variables, variant):
    jcfg, pcfg = _configs(variant)
    v = jax_variables(variant)
    sd = from_jax_variables(v, pcfg)
    create_model(pcfg).load_state_dict(sd, strict=True)
    back = convert_torch_state_dict(sd, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


def test_gated_sum_weights_through_from_jax_variables(jax_variables):
    """Every JAX variable of the gated sum lands in the port's state dict,
    the gate under the weighted fusion's names."""
    _, pcfg = _configs("gated_sum")
    v = jax_variables("gated_sum")
    sd = from_jax_variables(v, pcfg)
    model = create_model(pcfg)
    model.load_state_dict(sd, strict=True)
    assert isinstance(model.fusion.attention[3], torch.nn.Sigmoid)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v))
    n_port = sum(t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port
    f = v["params"]["fusion"]
    for i, n in ((0, 1), (2, 2)):
        np.testing.assert_array_equal(sd[f"fusion.attention.{i}.weight"].numpy(),
                                      f[f"attn{n}_kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"fusion.attention.{i}.bias"].numpy(),
                                      f[f"attn{n}_bias"])


@pytest.mark.parametrize("opt_ins", [False, True], ids=["plain_path", "kernel_path"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(jax_variables, rng, variant, opt_ins):
    jcfg, pcfg = _configs(variant, opt_ins)
    v = jax_variables(variant)
    images, pts, pv = _inputs(rng, jcfg)
    want = _jax_logits(jcfg, v, images, pts, pv)
    assert_varies(want)
    up = 4 if pcfg.output_mode == "x4" else 1
    got = Predictor(pcfg, from_jax_variables(v, pcfg), device="cpu")(images, pts, pv)
    assert got.shape == (2, GRID[0] * up, GRID[1] * up, 2) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    top2 = np.sort(want, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    assert not ((got.argmax(-1) != want.argmax(-1)) & (margin > 1e-3)).any()


def test_concat_bf16_logits_match_jax_bf16(jax_variables, rng):
    """compute_dtype=bfloat16 on both sides, kernel opt-ins on; |port - JAX|
    <= 2 G, G JAX's own bf16-vs-f32 gap on the same input
    (test_torch_model.py::test_bf16_logits_match_jax_bf16)."""
    jcfg, pcfg = _configs("concat", True)
    jcfg16, pcfg16 = _configs("concat", True, (jnp.bfloat16, torch.bfloat16))
    v = jax_variables("concat")
    images, pts, pv = _inputs(rng, jcfg)
    f32 = _jax_logits(jcfg, v, images, pts, pv)
    want = _jax_logits(jcfg16, v, images, pts, pv)
    gap = np.abs(want - f32).max()
    assert_varies(want)
    assert 0 < gap < 0.1 * np.abs(f32).max()
    got = Predictor(pcfg16, from_jax_variables(v, pcfg), device="cpu")(images, pts, pv)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= 2 * gap


@pytest.mark.parametrize("variant", ["concat", "minimal_x4"])
def test_train_step_matches_jax(jax_variables, rng, variant):
    """One train-mode forward of weighted CE and its backward on the kernel
    path, at a size where the x4 head's logits meet the labels (64^2 images,
    16^2 features, 64^2 logits), against JAX, within the tolerances of
    test_torch_ir_fused_train.py::test_whole_encoder_train_step_matches_jax:
    the loss as its forward outputs (atol 1e-4, rtol 1e-5), the BatchNorm
    running statistics after the step atol 1e-5, and every parameter
    gradient atol 5e-3, rtol 1e-4. At this size the reference's gradients
    are chaotic (train-mode BatchNorm over 8^2 maps of two samples): when
    its weights move by 1e-6 of themselves, concat's stage-5 gradients move
    by up to a quarter of their scale. So each gradient also gets 10 times
    that spread N of the reference's (max over the tensor), capped at 0.1
    max|g| of the tensor, as tests/test_torch_kd_step.py holds its steps,
    but never below N itself: where a ReLU6 input sits within rounding of a
    kink, the perturbed reference flips that mask entry and moves the
    gradient by a jump above the cap (concat's stage-5 expand weight, by
    0.0227, once at this size), and the port may land on either side."""
    jcfg, pcfg = _configs(variant, True)
    v = jax_variables(variant)
    images, pts, pv = _inputs(rng, jcfg)
    up = 4 if pcfg.output_mode == "x4" else 1
    labels = rng.integers(0, 2, (2, GRID[0] * up, GRID[1] * up)).astype(np.int32)
    model = jax_create_model(jcfg)

    def loss(params):
        logits, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                  jnp.asarray(images), jnp.asarray(pts), train=True,
                                  point_valid=jnp.asarray(pv), mutable=["batch_stats"])
        return jax_wce(logits, jnp.asarray(labels), jnp.asarray(CLASS_WEIGHTS)), \
            mut["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    noise = np.random.default_rng(3)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
        v["params"])
    with jax.default_matmul_precision("highest"):
        (want_loss, stats), grads = step(v["params"])
        _, grads_moved = step(moved)
    port = create_model(pcfg).train()
    port.load_state_dict(from_jax_variables(v, pcfg), strict=True)
    logits = port(torch.from_numpy(images), torch.from_numpy(pts), torch.from_numpy(pv))
    assert logits.shape[1:3] == labels.shape[1:]
    got_loss = weighted_cross_entropy(logits, torch.from_numpy(labels).long(),
                                      torch.tensor(CLASS_WEIGHTS))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), atol=1e-4, rtol=1e-5)
    sd = port.state_dict()
    want_sd = from_jax_variables({"params": v["params"], "batch_stats": stats}, pcfg)
    n_stats = 0
    for k, w in want_sd.items():
        if "running" in k:
            n_stats += 1
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
    assert n_stats == 2 * sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                              for m in port.modules())
    want_g = from_jax_variables({"params": grads, "batch_stats": stats}, pcfg)
    moved_g = from_jax_variables({"params": grads_moved, "batch_stats": stats}, pcfg)
    params = dict(port.named_parameters())
    assert set(params) <= set(want_g)
    for k, p in params.items():
        g, w = p.grad.numpy(), want_g[k].numpy()
        fixed = 5e-3 + 1e-4 * np.abs(w)
        n = np.abs(moved_g[k].numpy() - w)
        err = np.abs(g - w)
        spread = max(min(10 * n.max(), 0.1 * np.abs(w).max()), n.max())
        assert (err <= fixed + spread).all(), (k, float(err.max()), float(n.max()))



@pytest.mark.parametrize("variant", list(VARIANTS))
def test_taps_are_channels_last_views(rng, variant):
    """Every NCHW feature tap, concat's torch.cat and the x4 head's input
    included, lies in channels-last memory, so the taps' NHWC views that the
    KD losses and the feature-MSE kernel take (training/distill.py::
    channels_last) need no copy; the tap widths are tap_channels'."""
    _, pcfg = _configs(variant, True)
    images, pts, pv = _inputs(rng, _configs(variant, True)[0])
    with torch.no_grad():
        _, taps = create_model(pcfg).eval()(torch.from_numpy(images), torch.from_numpy(pts),
                                            torch.from_numpy(pv), return_intermediates=True)
    widths = tap_channels(pcfg)
    for k in ("camera_feat", "lidar_feat", "pre_fusion", "post_fusion"):
        assert taps[k].is_contiguous(memory_format=torch.channels_last), k
        assert taps[k].permute(0, 2, 3, 1).is_contiguous(), k
        assert taps[k].shape[1] == widths[k], k


@pytest.mark.parametrize("fusion", ["concat", "minimal", "weighted", "gated_sum"])
def test_tap_channels_match_jax(fusion):
    """The KD taps' widths for the full-width model and its 2x teacher, and
    for a small model whose camera and LiDAR widths differ."""
    for kw in (dict(fusion_out_channels=256 if fusion == "concat" else 128),
               dict(fusion_out_channels=48, camera_fpn_channels=24)):
        jcfg = JModel(num_classes=2, fusion_type=fusion, **kw)
        pcfg = ModelConfig(num_classes=2, fusion_type=fusion, **kw)
        for j, p in ((jcfg, pcfg), (jax_teacher_config(jcfg), teacher_config(pcfg))):
            assert tap_channels(p) == _tap_channels(None, j)
    if fusion == "concat":
        full = ModelConfig(num_classes=2)
        assert tap_channels(full)["post_fusion"] == 256
        assert tap_channels(teacher_config(full))["post_fusion"] == 512


# A concat student of tests/test_torch_kd_step.py's size (its camera FPN 16
# channels wide, the LiDAR features 32), fused to 48 channels.
CONCAT_STUDENT = {"fusion_type": "concat", "fusion_out_channels": 48}


@pytest.fixture(scope="module")
def jax_concat_step():
    """One JAX KD step of CONCAT_STUDENT (tests/test_torch_kd_step.py's batch
    and opt-ins), and the same from weights moved by 1e-6 of themselves."""
    return kd._jax_trajectory("sorted_pallas", steps=1, student=CONCAT_STUDENT)


def test_concat_kd_step_matches_jax(jax_concat_step, tmp_path):
    """DistillationTrainer.train_step for that concat student (its post_fusion
    tap 48 channels wide, the teacher's 96) and its 2x teacher against the
    JAX step: the loss, every gradient and the BatchNorm statistics, held to
    tests/test_torch_kd_step.py's protocol (a fixed margin plus 10x the
    reference's own spread under a 1e-6 weight perturbation, capped)."""
    kd.hold_kd_steps(jax_concat_step, tmp_path, "in_loop", "sorted_pallas",
                     student=CONCAT_STUDENT)
