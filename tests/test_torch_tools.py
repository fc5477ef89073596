"""The port's host tools (`python -m lmsu_tpu_torch.analyze_weighted_gate`,
`.visualize_predictions`, `.plot_training_curves`,
`.create_architecture_diagram`) on the CPU, against the JAX package's
scripts of the same names: the gate ablation's variants and statistics on
shared weights (small models), the per-sample IoU, the curves' printed
summary, the architecture counts; each tool end to end, its default
outputs under the port's output root and none of them a file git tracks,
and an error naming matplotlib where it is missing."""

import builtins
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import ExperimentConfig as JExperimentConfig
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.inference import Predictor as JPredictor
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.models import get_architecture_summary as jax_summary
from lmsu_tpu_torch import (analyze_weighted_gate, create_architecture_diagram,
                            plot_training_curves, visualize_predictions)
from lmsu_tpu_torch.common import OUTPUT_ROOT, import_pyplot
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   LidarEncoderConfig, ModelConfig)
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.utils.weights import from_jax_variables
from scripts import analyze_weighted_gate as jax_gate
from scripts import plot_training_curves as jax_curves
from scripts import visualize_predictions as jax_vis
from scripts.common import add_common_args as jax_common_args
from test_torch_model import jax_init_model

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
IMG, GRID, NPTS, B = 64, (16, 16), 256, 4


def tracked_files():
    """The files git tracks in this checkout, or None outside a git checkout."""
    out = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True, text=True)
    return set(out.stdout.split()) if out.returncode == 0 else None


def assert_outputs_untracked(written):
    """Every path written (relative to the directory the tool ran in) lies
    under the output root, which .gitignore lists, and none is a file git
    tracks."""
    assert written and all(Path(p).parts[0] == OUTPUT_ROOT for p in written), written
    assert f"/{OUTPUT_ROOT}/" in (ROOT / ".gitignore").read_text().split()
    tracked = tracked_files()
    if tracked is not None:
        assert not set(written) & tracked


def files_under(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def small_configs(fusion="weighted", pallas=False):
    kw = dict(num_classes=2, fusion_type=fusion, fusion_out_channels=16,
              camera_fpn_channels=16)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID)
    return (JModel(camera=JCam(base_channels=8), lidar=JLidar(**lid), **kw),
            ModelConfig(camera=CameraEncoderConfig(base_channels=8),
                        lidar=LidarEncoderConfig(**lid), use_pallas_fusion=pallas, **kw))


def batches(rng, n=2):
    out = []
    for _ in range(n):
        pts = rng.normal(0, 30, (B, NPTS, 4)).astype(np.float32)
        pv = np.ones((B, NPTS), bool)
        pv[:, -40:] = False
        out.append({"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
                    "points": pts, "point_valid": pv,
                    "segmentation": rng.integers(0, 2, (B, *GRID)),
                    "sample_mask": np.array([True] * (B - 1) + [n == 1])})
    return out


@pytest.fixture(scope="module")
def shared():
    """The small weighted model's JAX variables, the same weights as a port
    state dict, and two batches."""
    jcfg, pcfg = small_configs()
    variables = jax_init_model(jax_create_model(jcfg), 0)
    return jcfg, pcfg, variables, from_jax_variables(variables, pcfg), \
        batches(np.random.default_rng(5))


# -- analyze_weighted_gate ----------------------------------------------------

def test_gate_regime_matches_jax():
    """The analysis regime (weighted/128, hard synthetic, 400 / 512, B=32,
    class weights) equals the JAX script's, also with common flags set;
    --use-pallas-fusion (the port's) turns the gate kernel on."""
    jp = __import__("argparse").ArgumentParser()
    jax_common_args(jp)
    for argv in ([], ["--num-val", "64", "--batch-size", "8", "--seed", "3"]):
        j = jax_gate._regime(jp.parse_args(argv))
        p = analyze_weighted_gate._regime(analyze_weighted_gate.make_parser().parse_args(argv))
        for sub in ("data", "train"):
            jd = dataclasses.asdict(getattr(j, sub))
            jd.pop("log_every", None)
            assert jd == dataclasses.asdict(getattr(p, sub)), sub
        assert (j.model.fusion_type, j.model.fusion_out_channels, j.model.use_pallas_fusion) \
            == (p.model.fusion_type, p.model.fusion_out_channels, p.model.use_pallas_fusion)
    p = analyze_weighted_gate._regime(
        analyze_weighted_gate.make_parser().parse_args(["--use-pallas-fusion"]))
    assert p.model.use_pallas_fusion


def test_gate_variants_match_jax(shared):
    """Each variant's state dict is the JAX script's variant converted, bit
    for bit; each variant's logits on the port (plain gate and the gate
    kernel's plain version, a softmax saturated at +-20) are the JAX
    Predictor's within 5e-4."""
    jcfg, pcfg, variables, sd, data = shared
    jpred = JPredictor(jcfg, variables)
    preds = {pallas: Predictor(dataclasses.replace(pcfg, use_pallas_fusion=pallas), sd,
                               device="cpu") for pallas in (False, True)}
    for kind in analyze_weighted_gate.GATE_KINDS:
        jv = jax_gate._gate_variant(variables, kind)
        want_sd = from_jax_variables(jv, pcfg)
        got_sd = analyze_weighted_gate._gate_variant(sd, kind)
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            assert torch.equal(got_sd[k], v), (kind, k)
        jpred.variables = jax.device_put(jv)
        b = data[0]
        want = np.asarray(jpred(b["image"], b["points"], b["point_valid"]))
        for pred in preds.values():
            pred.model.load_state_dict(got_sd, strict=True)
            got = pred(b["image"], b["points"], b["point_valid"]).numpy()
            assert np.abs(got - want).max() <= 5e-4 * max(1.0, np.abs(want).max()), kind
    with pytest.raises(ValueError):
        analyze_weighted_gate._gate_variant(sd, "neither")


def test_gate_statistics_match_jax(shared, monkeypatch):
    """gate_statistics on shared weights and batches against the JAX
    script's (which captures the projections with capture_intermediates),
    unrounded (`round` stubbed in both modules), within 1e-5 of scale; the
    uniform variant's camera weight is exactly 0.5, camera_only's >= 1 - 1e-6."""
    jcfg, pcfg, variables, sd, data = shared
    for mod in (jax_gate, analyze_weighted_gate):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x, raising=False)
    jexp = JExperimentConfig(model=jcfg)
    pexp = ExperimentConfig(model=pcfg)
    want = jax_gate.gate_statistics(jax_create_model(jcfg), jax.device_put(variables), data,
                                    jexp, 2)
    pred = Predictor(pcfg, sd, device="cpu")
    got = analyze_weighted_gate.gate_statistics(pred, data, pexp, 2)

    def flat(d, pre=""):
        for k, v in d.items():
            yield from (flat(v, pre + k + ".") if isinstance(v, dict) else [(pre + k, v)])
    g, w = dict(flat(got)), dict(flat(want))
    assert set(g) == set(w) and g["n_pixels"] == w["n_pixels"] == 2 * B * GRID[0] * GRID[1]
    for k in w:
        assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), (k, g[k], w[k])
    assert 0.0 < w["camera_weight.std"]
    pred.model.load_state_dict(analyze_weighted_gate._gate_variant(sd, "uniform"))
    w_cam, occ = analyze_weighted_gate.gate_weights(pred, data, pexp, 2)
    assert (w_cam == 0.5).all() and occ.any() and not occ.all()
    pred.model.load_state_dict(analyze_weighted_gate._gate_variant(sd, "camera_only"))
    assert analyze_weighted_gate.gate_weights(pred, data, pexp, 1)[0].min() >= 1 - 1e-6


def test_analyze_weighted_gate_cli(shared, tmp_path, monkeypatch, capsys):
    """The tool end to end at a small size (its regime shrunk), from the
    defaults run in a fresh directory: the checkpoint read from and the
    analysis written under the output root, with the JAX script's schema."""
    jcfg, pcfg, variables, sd, data = shared
    real = analyze_weighted_gate._regime

    def regime(args):
        cfg = real(args)
        return cfg.replace(model=pcfg.replace(use_pallas_fusion=cfg.model.use_pallas_fusion),
                           data=dataclasses.replace(cfg.data, image_size=(IMG, IMG),
                                                    grid_size=GRID, max_points=NPTS))
    monkeypatch.setattr(analyze_weighted_gate, "_regime", regime)
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / OUTPUT_ROOT / "checkpoints" / "quant_accuracy" / "best.pth"
    ck.parent.mkdir(parents=True)
    torch.save({"model_state": sd}, ck)
    res = analyze_weighted_gate.main(["--device", "cpu", "--num-val", "8", "--batch-size", "4",
                                      "--num-workers", "0", "--stat-batches", "1",
                                      "--use-pallas-fusion"])
    out = tmp_path / OUTPUT_ROOT / "docs" / "weighted_gate_analysis.json"
    assert json.loads(out.read_text()) == res
    assert set(res) == {"benchmark", "checkpoint", "model", "gate_variants_val_miou",
                        "gate_stats", "gate_contribution_pt"}
    assert list(res["gate_variants_val_miou"]) == list(analyze_weighted_gate.GATE_KINDS)
    assert all(0.0 <= v["miou"] <= 1.0 for v in res["gate_variants_val_miou"].values())
    assert res["gate_stats"]["n_pixels"] == 4 * GRID[0] * GRID[1]
    assert "=== gate statistics (trained weights) ===" in capsys.readouterr().out
    written = files_under(tmp_path)
    assert_outputs_untracked(written)


# -- visualize_predictions ----------------------------------------------------

def test_compute_iou_per_sample_matches_jax():
    rng = np.random.default_rng(2)
    cases = [(rng.integers(0, 2, (16, 16)), rng.integers(0, 2, (16, 16))) for _ in range(5)]
    cases += [(np.zeros((4, 4), int), np.zeros((4, 4), int)),       # empty union: NaN
              (np.ones((4, 4), int), np.zeros((4, 4), int)),
              (np.full((4, 4), 2), np.full((4, 4), -1))]
    for pred, gt in cases:
        for cls in (0, 1):
            got = visualize_predictions.compute_iou_per_sample(pred, gt, cls)
            want = jax_vis.compute_iou_per_sample(pred, gt, cls)
            assert got == want or (np.isnan(got) and np.isnan(want))
    assert np.isnan(visualize_predictions.compute_iou_per_sample(*cases[5]))


def test_compute_predictions_keeps_real_samples(shared):
    """The compute part: real samples only (the padded last one dropped), in
    order, the argmax and its margin on the device, each IoU the JAX
    function's of the same masks."""
    _, pcfg, _, sd, data = shared
    pred = Predictor(pcfg, sd, device="cpu")
    got = visualize_predictions.compute_predictions(pred, data, num_samples=6)
    assert got["pred"].shape == (6, *GRID) and got["image"].shape == (6, IMG, IMG, 3)
    logits = [pred(b["image"], b["points"], b["point_valid"]).numpy() for b in data]
    want_pred = np.concatenate([logits[0][:B - 1], logits[1][:6 - (B - 1)]]).argmax(-1)
    np.testing.assert_array_equal(got["pred"], want_pred)
    assert (got["margin"] >= 0).all()
    np.testing.assert_array_equal(
        got["segmentation"], np.concatenate([data[0]["segmentation"][:B - 1],
                                             data[1]["segmentation"][:6 - (B - 1)]]))
    for p, g, iou in zip(got["pred"], got["segmentation"], got["iou"]):
        want = jax_vis.compute_iou_per_sample(p, g)
        assert iou == want or (np.isnan(iou) and np.isnan(want))


def test_visualize_predictions_cli(tmp_path, monkeypatch, capsys):
    """The tool end to end (full-width minimal/128 at B=2, two samples)
    from its defaults in a fresh directory: figures under the output root."""
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / OUTPUT_ROOT / "checkpoints" / "fusion_ablation_concat" / "best.pth"
    ck.parent.mkdir(parents=True)
    cfg = ModelConfig(num_classes=2, fusion_type="minimal", fusion_out_channels=128)
    torch.save({"model_state": create_model(cfg).state_dict()}, ck)
    samples = visualize_predictions.main(["--device", "cpu", "--fusion-type", "minimal",
                                          "--num-samples", "2", "--batch-size", "2"])
    assert samples["pred"].shape == (2, 64, 64)
    written = files_under(tmp_path)
    assert [p for p in written if p.endswith(".png")] == [
        f"{OUTPUT_ROOT}/visualizations/sample_000.png",
        f"{OUTPUT_ROOT}/visualizations/sample_001.png"]
    assert_outputs_untracked(written)
    assert "Wrote 2 figures" in capsys.readouterr().out


# -- plot_training_curves -----------------------------------------------------

def _history(rng, n):
    return {k: [float(v) for v in rng.uniform(0, 1, n)]
            for k in ("train_loss", "train_miou", "val_loss", "val_miou", "lr")}


def test_plot_training_curves_prints_the_jax_summary(tmp_path, monkeypatch, capsys):
    """Two runs' histories (a third without one): the printed summary is the
    JAX script's line for line; the PNG is written; from the defaults in a
    fresh directory the tool reads the ablation's runs under the output
    root and writes there."""
    rng = np.random.default_rng(4)
    runs = []
    for name, n in (("concat", 5), ("weighted", 3), ("missing", 0)):
        d = tmp_path / "runs" / name
        d.mkdir(parents=True)
        if n:
            (d / "training_history.json").write_text(json.dumps(_history(rng, n)))
        runs.append(str(d))
    want_rc = jax_curves.main(["--runs", *runs, "--output", str(tmp_path / "jax.png")])
    want = capsys.readouterr().out.split("\n")
    got_rc = plot_training_curves.main(["--runs", *runs, "--output", str(tmp_path / "p.png")])
    got = capsys.readouterr().out.split("\n")
    assert got_rc == want_rc == 0
    strip = [ln for ln in want if not ln.startswith("Wrote")]
    assert [ln for ln in got if not ln.startswith("Wrote")] == strip
    assert any("best val mIoU" in ln for ln in got)
    assert (tmp_path / "p.png").stat().st_size > 0
    with pytest.raises(SystemExit):
        plot_training_curves.main(["--runs", *runs, "--labels", "a"])

    monkeypatch.chdir(tmp_path)
    assert plot_training_curves.main([]) == 1
    d = tmp_path / OUTPUT_ROOT / "checkpoints" / "fusion_ablation_minimal"
    d.mkdir(parents=True)
    (d / "training_history.json").write_text(json.dumps(_history(rng, 2)))
    assert plot_training_curves.main([]) == 0
    assert (tmp_path / OUTPUT_ROOT / "training_curves.png").exists()
    assert_outputs_untracked([p for p in files_under(tmp_path) if p.endswith(".png")
                              and not p.startswith("runs/") and p != "jax.png" and p != "p.png"])


# -- create_architecture_diagram ----------------------------------------------

@pytest.mark.parametrize("fusion", ["concat", "minimal", "weighted", "gated_sum"])
def test_architecture_summary_matches_jax(fusion):
    """The counts the diagram prints are the JAX package's
    get_architecture_summary at full width (573,442 / 494,978 / 528,132 for
    concat / minimal / weighted), shapes by jax.eval_shape."""
    got = create_architecture_diagram.summary(fusion)
    jm = jax_create_model(JModel(num_classes=2, fusion_type=fusion,
                                 fusion_out_channels=256 if fusion == "concat" else 128))
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)),
                                              jnp.zeros((1, 16, 4)), train=False),
                            jax.random.PRNGKey(0))
    assert got == jax_summary(jm, shapes)
    want = {"concat": "573,442", "minimal": "494,978", "weighted": "528,132"}.get(fusion)
    assert want is None or got["total_params"] == want


def test_create_architecture_diagram_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    s = create_architecture_diagram.main(["--fusion-type", "weighted", "--html", "arch.html"])
    assert s["total_params"] == "528,132"
    html = (tmp_path / "arch.html").read_text()
    assert "<td>total params</td><td>528,132</td>" in html
    assert (tmp_path / OUTPUT_ROOT / "architecture_diagram.png").stat().st_size > 0
    assert "total_params: 528,132" in capsys.readouterr().out
    assert_outputs_untracked([p for p in files_under(tmp_path) if p.endswith(".png")])


# -- matplotlib missing -------------------------------------------------------

def test_tools_name_a_missing_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib a tool asked for figures raises an error naming it,
    before any work: it never skips them silently."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="matplotlib"):
        import_pyplot()
    for call in (lambda: create_architecture_diagram.main([]),
                 lambda: plot_training_curves.main([]),
                 lambda: visualize_predictions.main(["--device", "cpu"])):
        with pytest.raises(RuntimeError, match="matplotlib"):
            call()
    assert files_under(tmp_path) == []
