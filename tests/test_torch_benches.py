"""The port's serving, frozen-predictor and input benches and its dress
rehearsal on the CPU, at --tiny sizes (their plain versions):

  * percentiles and bench_shapes equal the scripts' on the same input;
  * bench_serving --tiny runs a 0.5 s closed-loop level and an open-loop
    saturation of the null backend, whose forward returns the port engine's
    layout (a tensor [B, h, w, classes] in the compute dtype), and writes
    its result under the output root;
  * bench_frozen_predictor's chain of K forwards ends on the output of one
    forward of its last input (f32, 1e-5 of scale), the frozen copy's
    within 1e-5 of scale of the module path's;
  * dress_rehearsal --tiny --modes packed,onchip on numpy-made packs, no PIL
    or pandas needed, and it refuses the raw modes with them;
  * fabricate_scenes without PIL or pandas raises naming what is missing."""

import builtins
import json

import numpy as np
import pytest
import torch

import scripts.bench_serving as jax_bench_serving
from bench import bench_shapes as jax_bench_shapes
from lmsu_tpu_torch import bench_frozen_predictor as bfp
from lmsu_tpu_torch import bench_input_pipeline, bench_serving, dress_rehearsal
from lmsu_tpu_torch.inference import Predictor

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def test_percentiles_and_shapes_equal_the_scripts(rng):
    for n in (0, 1, 7, 1000, 1500):
        lats = list(rng.exponential(0.01, n))
        assert bench_serving.percentiles(lats) == jax_bench_serving.percentiles(lats)
    for tiny in (True, False):
        assert bfp.bench_shapes(tiny) == jax_bench_shapes(tiny)
    a = bench_serving.make_frame_pool(np.random.default_rng(7), 3, 16, 40)
    b = jax_bench_serving.make_frame_pool(np.random.default_rng(7), 3, 16, 40)
    assert all(np.array_equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))


def test_bench_serving_tiny_load_and_null_backend(tmp_path):
    res = bench_serving.main(["--tiny", "--device", "cpu", "--duration", "0.5",
                              "--concurrency", "2", "--batch-size", "4", "--frames", "8",
                              "--saturation", "0.5", "--null-backend-ms", "2",
                              "--output-root", str(tmp_path)])
    det = res["detail"]
    assert res["device"] == "cpu" and det["backend"] == "cpu" and det["dtype"] == "float32"
    assert det["levels"][0]["completed"] > 0 and det["saturation"]["completed"] > 0
    assert det["null_backend"]["completed"] > 0 and det["null_backend"]["occupancy"] > 0
    assert json.loads((tmp_path / "docs" / "serving_bench.json").read_text()) == \
        json.loads(json.dumps(res))
    cfg, _, _ = bench_serving.serving_model_config(
        bench_serving.make_parser().parse_args(["--tiny"]), on_card=False)
    out = bench_serving.null_backend(cfg, 0.0)(np.zeros((3, 64, 64, 3), np.uint8), None)
    assert isinstance(out, torch.Tensor)
    assert out.shape == (3, 16, 16, 2) and out.dtype == cfg.compute_dtype


def test_frozen_chain_equals_single_forwards(rng):
    """The last of K chained forwards equals one forward of its input
    (images + eps: the chain's mean(prev) * 0 adds nothing), and the frozen
    copy's chain the module path's, both within 1e-5 of scale in f32."""
    img_hw, n_pts, _ = bfp.bench_shapes(True)
    cfg = bfp.bench_config(tiny=True, on_card=False, fp32=True)
    state = bfp.bench_state(cfg)
    runtime = Predictor(cfg, state, device="cpu")
    frozen = Predictor(cfg, state, device="cpu", freeze_weights=True)
    row = bfp.run_batch(runtime, frozen, rng, 2, img_hw, n_pts, iters=3)
    assert row["runtime_ms"] > 0 and row["frozen_ms"] > 0 and row["one_forward_ms"] > 0
    outs = row["outputs"]
    images, points, pv = outs["inputs"]
    single = runtime.forward_batch(images, points, pv)
    for _ in range(2):  # K single forwards on the same inputs: the same output
        again = runtime.forward_batch(images, points, pv)
        assert torch.equal(again, single)
    scale = single.abs().max()
    assert (outs["runtime"] - single).abs().max() <= 1e-5 * scale
    assert (outs["frozen"] - single).abs().max() <= 1e-5 * scale
    assert single.shape == (2, 16, 16, 2) and torch.isfinite(single).all()


def _block(monkeypatch, *names):
    real = builtins.__import__

    def fake(name, *a, **kw):
        if name.split(".")[0] in names:
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", fake)
    monkeypatch.setattr(bench_input_pipeline, "_missing", lambda m: m in names)


def test_dress_rehearsal_packed_on_numpy_frames(tmp_path, monkeypatch):
    """packed and onchip modes from numpy-made packs with PIL and pandas
    blocked: two epochs each, frames/s and stall recorded under the root."""
    _block(monkeypatch, "PIL", "pandas")
    res = dress_rehearsal.main(["--tiny", "--modes", "packed,onchip", "--numpy-frames",
                                "--device", "cpu", "--frames", "40", "--epochs", "2",
                                "--batch-size", "4", "--num-workers", "0",
                                "--root", str(tmp_path / "tree"),
                                "--output-root", str(tmp_path / "runs")])
    assert res["frame_source"] == "numpy" and res["device"] == "cpu"
    for mode in ("packed", "onchip"):
        rows = res["modes"][mode]
        assert [r["epoch"] for r in rows] == [1, 2]
        assert all(r["frames_per_sec"] > 0 and 0 <= r["stall_frac"] <= 1 for r in rows)
    assert json.loads((tmp_path / "tree_pack" / "train" / "meta.json").read_text())["n"] == 32
    assert (tmp_path / "runs" / "docs" / "dress_rehearsal.json").exists()
    with pytest.raises(SystemExit, match="raw"):
        dress_rehearsal.main(["--tiny", "--modes", "raw,packed", "--numpy-frames",
                              "--device", "cpu"])


def test_numpy_frames_split_as_a_tree_is(monkeypatch):
    """numpy_frame_datasets splits scenes of 16 frames 80/20 as a fabricated
    tree is split, and decodes each frame to the sample contract."""
    from lmsu_tpu_torch.config import DataConfig
    cfg = DataConfig(dataset="pandaset", image_size=(32, 32), grid_size=(8, 8),
                     max_points=512)
    train, val = bench_input_pipeline.numpy_frame_datasets(40, 700, cfg)
    assert (len(train), len(val)) == (32, 8)
    s = train[3]
    assert s["image"].shape == (32, 32, 3) and s["points"].shape == (512, 4)
    assert s["segmentation"].shape == (8, 8) and s["point_valid"].all()
    assert s["sample_token"] == "000_03"
    assert np.array_equal(train[3]["points"], s["points"])


@pytest.mark.parametrize("missing", [("PIL",), ("pandas",), ("PIL", "pandas")])
def test_fabricate_scenes_names_what_is_missing(tmp_path, monkeypatch, missing):
    _block(monkeypatch, *missing)
    with pytest.raises(RuntimeError) as err:
        bench_input_pipeline.fabricate_scenes(str(tmp_path), 2, 10)
    for m in missing:
        assert m in str(err.value)
    assert not list(tmp_path.iterdir())
