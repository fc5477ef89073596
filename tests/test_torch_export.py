"""Serving artifacts of the port (Predictor.export, load_exported,
ServingEngine.from_exported) on the CPU at a small size: torch.export of the
frozen model, the kernels as the port's operators in the graph
(ops/_cuda.py::define_op, their plain versions here), the point-sort
contract carried in the artifact, and the JAX package's own export of the
same weights (jax.export) as the reference. Artifacts are written and
loaded in one process: torch.export ties one to the torch version that
wrote it."""

import jax
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.inference import Predictor as JaxPredictor
from lmsu_tpu.inference import load_exported as jax_load_exported
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.inference import ARTIFACT_META, Predictor, load_exported
from lmsu_tpu_torch.ops import fusion_gate, ir_fused, scatter_sorted, voxelize
from lmsu_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

IMG, NPTS, GRID = 32, 100, (8, 8)
OPS = {"segment_max": scatter_sorted._SEGMENT_MAX,
       "segment_max_flat": scatter_sorted._SEGMENT_MAX_FLAT,
       "scatter_max": voxelize._SCATTER_MAX, "fusion_gate": fusion_gate._FUSION_GATE,
       "fused_ir_infer": ir_fused._FUSED_IR_INFER}


def configs(fusion="concat", scatter="xla", kernels=False):
    """tests/test_inference.py's small model in both packages; with
    `kernels` the fused blocks and (weighted) the fused gate."""
    kw = dict(num_classes=2, fusion_type=fusion, fusion_out_channels=32,
              camera_fpn_channels=16, use_pallas_fusion=kernels)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID, scatter_impl=scatter)
    return (JModel(camera=JCam(base_channels=4, fused_inference=kernels), lidar=JLidar(**lid),
                   **kw),
            ModelConfig(camera=CameraEncoderConfig(base_channels=4, fused_inference=kernels),
                        lidar=LidarEncoderConfig(**lid), **kw))


def predictor(fusion="concat", scatter="xla", kernels=False, seed=0) -> Predictor:
    """Seeded weights, randomised BN statistics (centred means)."""
    pred = Predictor(configs(fusion, scatter, kernels)[1], device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in pred.model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.running_mean.normal_(0, 0.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
        pred.model.lidar_encoder.encoder.point_mlp[-2].weight.mul_(0.05)
    return pred


def inputs(seed=0, n=2):
    r = np.random.default_rng(seed)
    imgs = r.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)
    pts = r.normal(0, 20, (n, NPTS, 4)).astype(np.float32)
    pts[..., 3] = r.uniform(0, 1, (n, NPTS))
    pv = r.uniform(size=(n, NPTS)) > 0.2
    return imgs, pts, pv


def graph_ops(fn) -> set:
    return {str(n.target).split(".")[1] for n in fn.program.graph.nodes
            if str(n.target).startswith("lmsu_tpu_torch.")}


@pytest.mark.parametrize("with_pv", [True, False], ids=["point_valid", "no_point_valid"])
def test_export_roundtrip(tmp_path, with_pv):
    """tests/test_inference.py:103-140: export, load, the same logits within
    1e-5 of scale; the artifact records its inputs and its device."""
    pred = predictor()
    b = 2 if with_pv else 1
    path = str(tmp_path / "student.pt2")
    pred.export(path, batch_size=b, image_size=(IMG, IMG), num_points=NPTS,
                with_point_valid=with_pv)
    serve = load_exported(path)
    assert serve.meta["with_point_valid"] == with_pv and serve.meta["device"] == "cpu"
    assert (serve.meta["batch_size"], serve.meta["num_points"]) == (b, NPTS)
    imgs, pts, pv = inputs(1, b)
    got = serve(imgs, pts, pv if with_pv else None).numpy()
    want = pred(imgs, pts, pv if with_pv else None).numpy()
    assert got.shape == want.shape == (b, *GRID, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="point_valid"):
        serve(imgs, pts, None if with_pv else pv)


def test_quantised_artifact_reproduces_in_process_forward(tmp_path):
    """tests/test_quant.py:143-162: quantize() then export(): the artifact
    serves the int8 graph, within 1e-5 of scale of the in-process int8
    forward with equal argmax."""
    pred = predictor("weighted", kernels=True)
    imgs, pts, pv = inputs(2)
    flt = pred(imgs[:1], pts[:1]).numpy()
    pred.quantize([(imgs, pts)])
    want = pred(imgs[:1], pts[:1]).numpy()
    path = str(tmp_path / "quant.pt2")
    pred.export(path, batch_size=1, image_size=(IMG, IMG), num_points=NPTS,
                with_point_valid=False)
    serve = load_exported(path)
    assert serve.meta["quantized"]
    got = serve(imgs[:1], pts[:1]).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(flt - want).max() > 1e-3 * scale  # the int8 graph, not the float one
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("scatter, flat, ops", [
    ("sorted_pallas", False, {"segment_max", "fusion_gate", "fused_ir_infer"}),
    ("sorted_pallas", True, {"segment_max_flat", "fusion_gate", "fused_ir_infer"}),
    ("pallas", False, {"scatter_max", "fusion_gate", "fused_ir_infer"})],
    ids=["K1", "K4", "K6"])
def test_kernel_config_exports_its_operators_and_serves_unsorted_frames(
        tmp_path, monkeypatch, scatter, flat, ops):
    """The serving configuration (the sorted scatter K1, or K4 under
    _FWD_FLAT, or the unsorted K6; the fused gate K2; the fused blocks K3)
    exports with the kernels as the port's operators in the graph, five K3
    calls; the artifact records its scatter route, and from_exported sorts
    unsorted frames for the sorted route, so the engine answers as the
    Predictor does (which sorts them itself)."""
    monkeypatch.setattr(scatter_sorted, "_FWD_FLAT", flat)
    pred = predictor("weighted", scatter, kernels=True)
    path = str(tmp_path / "k.pt2")
    pred.export(path, batch_size=2, image_size=(IMG, IMG), num_points=NPTS)
    fn = load_exported(path)
    assert graph_ops(fn) == ops
    assert sum(str(n.target) == "lmsu_tpu_torch.fused_ir_infer.default"
               for n in fn.program.graph.nodes) == 5
    assert fn.meta["scatter_impl"] == scatter and fn.meta["grid_size"] == list(GRID)
    imgs, pts, pv = inputs(3, 3)
    with ServingEngine.from_exported(path, batch_size=2, num_points=NPTS,
                                     image_size=(IMG, IMG), max_delay_ms=20.0) as eng:
        assert (eng._sorter is not None) == (scatter == "sorted_pallas")
        assert eng.image_dtype == np.float32
        got = np.stack([eng.submit(imgs[i], pts[i], pv[i]).result(60) for i in range(3)])
        with pytest.raises(RuntimeError, match="baked"):
            eng.swap_variables(pred.model.state_dict())
    want = pred(imgs, pts, pv).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_ladder_and_other_specs_are_refused(tmp_path):
    pred = predictor()
    path = str(tmp_path / "a.pt2")
    pred.export(path, batch_size=2, image_size=(IMG, IMG), num_points=NPTS)
    kw = dict(num_points=NPTS, image_size=(IMG, IMG))
    with pytest.raises(ValueError, match="single-shape"):
        ServingEngine.from_exported(path, batch_size=2, batch_sizes=[1, 2], **kw)
    with pytest.raises(ValueError, match="exported for"):
        ServingEngine.from_exported(path, batch_size=4, **kw)
    with pytest.raises(ValueError, match="runs on cpu"):
        ServingEngine.from_exported(path, batch_size=2, device="cuda", **kw)
    extra = {ARTIFACT_META: ""}
    torch.export.load(path, extra_files=extra)
    assert '"scatter_impl": "xla"' in extra[ARTIFACT_META]


def test_exported_logits_match_jax_export(tmp_path):
    """The port's artifact against the JAX package's jax.export artifact of
    the same weights (its default path) on the same inputs: within the
    parity bar, 5e-4 of scale."""
    pred = predictor()
    jcfg, _ = configs()
    jpath, path = str(tmp_path / "j.stablehlo"), str(tmp_path / "t.pt2")
    with jax.default_matmul_precision("highest"):
        JaxPredictor(jcfg, convert_torch_state_dict(pred.model.state_dict(), jcfg)).export(
            jpath, batch_size=2, image_size=(IMG, IMG), num_points=NPTS)
    pred.export(path, batch_size=2, image_size=(IMG, IMG), num_points=NPTS)
    imgs, pts, pv = inputs(4)
    want = np.asarray(jax_load_exported(jpath)(imgs, pts, pv))
    got = load_exported(path)(imgs, pts, pv).numpy()
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


def _opcheck_args(name):
    g = torch.Generator().manual_seed(0)
    f = torch.randn(2, 16, 8, generator=g)
    keys = torch.sort(torch.randint(0, 17, (2, 16), generator=g, dtype=torch.int32), dim=1)[0]
    if name in ("segment_max", "segment_max_flat", "scatter_max"):
        return (f, keys, 16), {}
    if name == "fusion_gate":
        cam, lid = torch.randn(2, 3, 3, 8, generator=g), torch.randn(2, 3, 3, 8, generator=g)
        return (cam, lid, torch.randn(8, 16, 1, 1, generator=g), torch.randn(8, generator=g),
                torch.randn(2, 8, 1, 1, generator=g), torch.randn(2, generator=g)), {}
    x = torch.randn(2, 5, 5, 8, generator=g)
    p = ir_fused.IRParams(torch.randn(8, 16, generator=g), torch.rand(16, generator=g),
                          torch.rand(16, generator=g), torch.randn(3, 3, 16, generator=g),
                          torch.rand(16, generator=g), torch.rand(16, generator=g),
                          torch.randn(16, 8, generator=g), torch.rand(8, generator=g),
                          torch.rand(8, generator=g))
    return (x, *p), {"stride": 2}


@pytest.mark.parametrize("name", sorted(OPS))
def test_operators_pass_opcheck(name):
    """Each operator's schema, fake implementation (the shapes an exporting
    trace sees) and dispatch agree with its CPU implementation."""
    args, kwargs = _opcheck_args(name)
    result = torch.library.opcheck(OPS[name], args, kwargs)
    assert set(result.values()) == {"SUCCESS"}, result


def test_export_model_cli(tmp_path, monkeypatch, capsys):
    """`python -m lmsu_tpu_torch.export_model`: scripts/export_model.py's
    flags; the model built as `serve` builds it (here narrowed); --platforms
    cpu traces for the CPU, cuda (the default) needs the card, tpu is
    refused by name."""
    from lmsu_tpu_torch import export_model, serve
    small = configs("weighted", "sorted_pallas", kernels=True)[1]
    monkeypatch.setattr(serve, "build_config", lambda a: small)
    ckpt, out = tmp_path / "w.pth", tmp_path / "w.pt2"
    torch.save(predictor("weighted", "sorted_pallas", kernels=True).model.state_dict(), ckpt)
    flags = ["--checkpoint", str(ckpt), "--output", str(out), "--num-points", str(NPTS)]
    export_model.main(flags + ["--platforms", "cpu", "--batch-size", "2"])
    assert "Wrote" in capsys.readouterr().out
    fn = load_exported(str(out))
    assert fn.meta["image_size"] == [256, 256] and fn.meta["scatter_impl"] == "sorted_pallas"
    assert graph_ops(fn) == {"segment_max", "fusion_gate", "fused_ir_infer"}
    with pytest.raises(SystemExit, match="not tpu"):
        export_model.main(flags + ["--platforms", "tpu"])
    with pytest.raises(SystemExit, match="one platform"):
        export_model.main(flags + ["--platforms", "cpu", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(flags)
