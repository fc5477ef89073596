"""Frozen serving of the port (Predictor(freeze_weights=True),
models/frozen.py) on the CPU at a small size, against the unfrozen port and
the JAX package's frozen Predictor: every eval BatchNorm folded into its
conv once, the fused blocks' parameters folded once, int8 layers quantised
once; the engine refuses a swap of baked weights; `serve`'s new flags
(--freeze-weights, --artifact, --no-point-valid) parse and build."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.inference import Predictor as JaxPredictor
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch import serve
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.frozen import FrozenIRParams, Int8Conv
from lmsu_tpu_torch.models.layers import InvertedResidual
from lmsu_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

IMG, NPTS, GRID = 32, 100, (8, 8)


def configs(opt_ins: bool, fusion: str = "weighted"):
    """The same small model in both packages; with the kernel opt-ins (the
    sorted scatter, the fused gate, the fused blocks) or without."""
    kw = dict(num_classes=2, fusion_type=fusion, fusion_out_channels=16,
              camera_fpn_channels=16, use_pallas_fusion=opt_ins)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID,
               scatter_impl="sorted_pallas" if opt_ins else "xla")
    return (JModel(camera=JCam(base_channels=4, fused_inference=opt_ins), lidar=JLidar(**lid),
                   **kw),
            ModelConfig(camera=CameraEncoderConfig(base_channels=4, fused_inference=opt_ins),
                        lidar=LidarEncoderConfig(**lid), **kw))


@functools.lru_cache(maxsize=None)
def state_dict(fusion: str = "weighted"):
    """Seeded weights with randomised BN statistics, so the fold has content:
    scales and variances U(0.5, 2) as tests/test_inference.py's frozen test
    draws them, means centred (N(0, 0.2): means from the variances' law
    zero every ReLU of the head), the point MLP's last BN scaled down so
    both streams move the logits."""
    model = create_model(configs(False, fusion)[1], seed=1)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 2.0, generator=g)
                m.running_mean.normal_(0, 0.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
        model.lidar_encoder.encoder.point_mlp[-2].weight.mul_(0.05)
    return model.state_dict()


def frames(seed=0, n=2):
    r = np.random.default_rng(seed)
    imgs = r.integers(0, 256, (n, IMG, IMG, 3)).astype(np.uint8)
    pts = r.normal(0, 20, (n, NPTS, 4)).astype(np.float32)
    pts[..., 3] = r.uniform(0, 1, (n, NPTS))
    pv = r.uniform(size=(n, NPTS)) > 0.2
    return imgs, pts, pv


@pytest.mark.parametrize("opt_ins", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("fusion", ["weighted", "concat"])
def test_frozen_matches_unfrozen(opt_ins, fusion):
    """tests/test_inference.py:40-58's bar: frozen == unfrozen within atol
    1e-5; the frozen copy keeps no BatchNorm, its fused blocks hold their
    folded parameters, and the Predictor's own model is untouched."""
    _, pcfg = configs(opt_ins, fusion)
    sd = state_dict(fusion)
    a = Predictor(pcfg, sd, device="cpu")
    b = Predictor(pcfg, sd, device="cpu", freeze_weights=True)
    imgs, pts, pv = frames()
    want, got = a(imgs, pts, pv).numpy(), b(imgs, pts, pv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want).max() > 0.1
    assert not any(isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))
                   for m in b._served.modules())
    blocks = [m for m in b._served.modules() if isinstance(m, InvertedResidual)]
    assert len(blocks) == 5
    assert all(isinstance(m.frozen, FrozenIRParams) == opt_ins for m in blocks)
    assert b.model is not b._served
    assert all(torch.equal(v, sd[k]) for k, v in b.model.state_dict().items())


def test_frozen_matches_jax_frozen_predictor():
    """The port's frozen serving Predictor (kernel opt-ins on, their plain
    versions here) against the JAX package's frozen Predictor (its default
    path) on the same weights: within the parity bar, 5e-4 of scale."""
    jcfg, _ = configs(False)
    _, pcfg = configs(True)
    sd = state_dict()
    imgs, pts, pv = frames(1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxPredictor(jcfg, convert_torch_state_dict(sd, jcfg),
                                       freeze_weights=True)(imgs, pts, pv))
    got = Predictor(pcfg, sd, device="cpu", freeze_weights=True)(imgs, pts, pv).numpy()
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


def test_quantize_rebuilds_the_frozen_copy():
    """quantize() on a frozen Predictor rebuilds its copy with the int8
    layers in it (BN folded and weights quantised once), near the unfrozen
    int8 forward: within 2e-2 of scale, since folding BN into the float
    convs moves the int8 layers' inputs by f32 rounding, and an input on a
    rounding edge moves its int8 value by one step (equal on the CPU at this size)."""
    _, pcfg = configs(True)
    imgs, pts, pv = frames(2)
    a = Predictor(pcfg, state_dict(), device="cpu")
    b = Predictor(pcfg, state_dict(), device="cpu", freeze_weights=True)
    before = b._served
    for p in (a, b):
        p.quantize([(imgs, pts, pv)])
    assert b._served is not before
    assert sum(isinstance(m, Int8Conv) for m in b._served.modules()) == 8
    want = a(imgs, pts, pv).numpy()
    assert np.abs(b(imgs, pts, pv).numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_engine_refuses_to_swap_baked_weights():
    _, pcfg = configs(True)
    frozen = Predictor(pcfg, state_dict(), device="cpu", freeze_weights=True)
    kw = dict(batch_size=2, image_size=(IMG, IMG), num_points=NPTS)
    with ServingEngine.from_predictor(frozen, **kw) as eng:
        with pytest.raises(RuntimeError, match="baked"):
            eng.swap_variables(frozen.model.state_dict())
        imgs, pts, pv = frames(3, 1)
        np.testing.assert_allclose(eng.predict(imgs[0], pts[0], pv[0], timeout=60),
                                   frozen(imgs, pts, pv).numpy()[0], atol=1e-6)
    live = Predictor(pcfg, state_dict(), device="cpu")
    with ServingEngine.from_predictor(live, **kw) as eng:
        eng.swap_variables(frozen.model.state_dict())


def _small(cfg):
    return dataclasses.replace(configs(True, cfg.fusion_type)[1],
                               compute_dtype=cfg.compute_dtype)


def test_serve_flags_parse_and_build(tmp_path, monkeypatch):
    """--freeze-weights builds a frozen engine (no swap); --artifact with
    --no-point-valid serves an artifact exported without the mask;
    --artifact excludes --checkpoint, and its engine refuses a ladder."""
    args = serve.parse_args([])
    assert (args.freeze_weights, args.artifact, args.no_point_valid) == (False, None, False)
    monkeypatch.setattr(serve, "build_config", lambda a, real=serve.build_config: _small(real(a)))
    small = ["--device", "cpu", "--image-size", str(IMG), str(IMG), "--num-points", str(NPTS),
             "--batch-size", "2"]
    eng = serve.build_engine(serve.parse_args(small + ["--freeze-weights", "--seed", "3"]))
    try:
        assert eng._swap is None
        eng.warmup()
    finally:
        eng.close()
    pred = Predictor(serve.build_config(args), device="cpu", seed=3)
    path = str(tmp_path / "nopv.pt2")
    pred.export(path, batch_size=2, image_size=(IMG, IMG), num_points=NPTS,
                with_point_valid=False)
    eng = serve.build_engine(serve.parse_args(small + ["--artifact", path, "--no-point-valid"]))
    try:
        assert not eng.passes_point_valid and eng._sorter is not None
        eng.warmup()
        imgs, pts, _ = frames(4, 1)
        want = pred(imgs.astype(np.float32) / 255.0, pts).numpy()[0]
        np.testing.assert_allclose(eng.predict(imgs[0], pts[0], timeout=60), want, atol=1e-5)
    finally:
        eng.close()
    with pytest.raises(SystemExit):
        serve.parse_args(["--artifact", path, "--checkpoint", path])
    with pytest.raises(ValueError, match="single-shape"):
        serve.build_engine(serve.parse_args(small + ["--artifact", path, "--no-point-valid",
                                                     "--batch-sizes", "1", "2"]))
    with pytest.raises(ValueError, match="exported for"):
        serve.build_engine(serve.parse_args(small + ["--artifact", path]))
