"""The port's serving runtime on a CPU Predictor: the engine is a pure
wrapper (concurrent requests answer exactly as the direct call does), and
the HTTP front-end round-trips npz and JSON."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from lmsu_tpu_torch import serve
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.serving import ServingEngine, make_server

torch.set_num_threads(2)

IMG = (32, 32)
NPTS = 64


@pytest.fixture
def rng():
    return np.random.default_rng(9)


@pytest.fixture(scope="module")
def predictor():
    cfg = ModelConfig(
        num_classes=2, fusion_type="weighted", fusion_out_channels=16,
        camera_fpn_channels=16, use_pallas_fusion=True,
        camera=CameraEncoderConfig(base_channels=4, fused_inference=True),
        lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8),
                                 scatter_impl="sorted_pallas"))
    return Predictor(cfg, device="cpu", seed=3)


def _engine(predictor, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("image_size", IMG)
    kw.setdefault("num_points", NPTS)
    kw.setdefault("max_delay_ms", 20.0)
    return ServingEngine.from_predictor(predictor, **kw)


def _frames(rng, n, npts=NPTS):
    imgs = rng.integers(0, 256, (n, *IMG, 3)).astype(np.uint8)
    pts = rng.normal(0, 20, (n, npts, 4)).astype(np.float32)
    pv = rng.uniform(size=(n, npts)) > 0.3
    return imgs, pts, pv


def test_concurrent_requests_match_direct(predictor, rng):
    """7 requests from 7 threads through a B=4 engine each match the direct
    batched Predictor on the same inputs."""
    imgs, pts, pv = _frames(rng, 7)
    want = predictor(imgs, pts, pv).numpy()
    got = [None] * 7
    with _engine(predictor) as eng:
        def client(i):
            got[i] = eng.predict(imgs[i], pts[i], pv[i], timeout=120)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
    np.testing.assert_allclose(np.stack(got), want, atol=1e-6)
    assert st["requests"] == 7 and st["batches"] >= 2


def test_padding_and_subsampling_match_direct(predictor, rng):
    """Short clouds are padded (pads invalid) and long ones stride-subsampled
    to the engine's point count, before the cell sort."""
    imgs, _, _ = _frames(rng, 2)
    short = rng.normal(0, 20, (40, 4)).astype(np.float32)
    long = rng.normal(0, 20, (100, 4)).astype(np.float32)
    with _engine(predictor) as eng:
        got = [eng.predict(imgs[0], short), eng.predict(imgs[1], long)]
        prepped = [eng._prep_points(p, None) for p in (short, long)]
    want = predictor(imgs, np.stack([p for p, _ in prepped]),
                     np.stack([v for _, v in prepped])).numpy()
    np.testing.assert_allclose(np.stack(got), want, atol=1e-6)


def test_swap_variables_and_predict_mask(predictor, rng):
    imgs, pts, pv = _frames(rng, 1)
    other = Predictor(predictor.config, device="cpu", seed=4)
    with _engine(predictor) as eng:
        before = eng.predict(imgs[0], pts[0], pv[0])
        eng.swap_variables(other.model.state_dict())
        after = eng.predict(imgs[0], pts[0], pv[0])
        eng.swap_variables(Predictor(predictor.config, device="cpu", seed=3)
                           .model.state_dict())
        mask = eng.predict_mask(imgs[0], pts[0], pv[0])
    np.testing.assert_allclose(after, other(imgs, pts, pv).numpy()[0], atol=1e-6)
    assert not np.allclose(before, after)
    direct = predictor.predict_mask(imgs[0], pts[0], pv[0])
    assert mask.shape == direct.shape == (8, 8) and direct.dtype == np.int32
    np.testing.assert_array_equal(mask, direct)


def test_http_round_trip(predictor, rng):
    imgs, pts, pv = _frames(rng, 1)
    want = predictor(imgs, pts, pv).numpy()[0]
    with _engine(predictor, max_delay_ms=1.0) as eng:
        server = make_server(eng, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            buf = io.BytesIO()
            np.savez(buf, image=imgs[0], points=pts[0], point_valid=pv[0])
            req = urllib.request.Request(f"{base}/v1/predict", data=buf.getvalue(),
                                         headers={"Content-Type": "application/x-npz"})
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.load(io.BytesIO(r.read()))["logits"]
            body = json.dumps({"image": imgs[0].tolist(), "points": pts[0].tolist(),
                               "point_valid": pv[0].tolist()}).encode()
            req = urllib.request.Request(f"{base}/v1/predict?output=mask", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                mask = np.asarray(json.loads(r.read())["mask"])
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                assert json.loads(r.read()) == {"ok": True}
            with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
                assert json.loads(r.read())["requests"] == 2
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(mask, want.argmax(-1))


def test_serve_cli_builds_the_kernel_path_engine_on_cpu(rng):
    """The serve CLI's engine: the full-width weighted student with the
    three kernel opt-ins, here on the CPU at a small image size."""
    args = serve.parse_args(["--device", "cpu", "--image-size", "32", "32",
                             "--num-points", "64", "--batch-size", "2"])
    cfg = serve.build_config(args)
    assert (cfg.use_pallas_fusion, cfg.camera.fused_inference,
            cfg.lidar.scatter_impl) == (True, True, "sorted_pallas")
    eng = serve.build_engine(args)
    try:
        imgs, pts, _ = _frames(rng, 1)
        out = eng.predict(imgs[0], pts[0], timeout=120)
    finally:
        eng.close()
    assert out.shape == (8, 8, 2) and np.isfinite(out).all()


@pytest.mark.parametrize("wrap", [False, True], ids=["state_dict", "trainer_checkpoint"])
def test_from_torch_checkpoint(predictor, rng, tmp_path, wrap):
    """A saved port state dict, or a reference trainer checkpoint holding it
    under 'model_state', loads strictly and predicts the same."""
    sd = predictor.model.state_dict()
    path = tmp_path / "model.pth"
    torch.save({"model_state": sd, "epoch": 3} if wrap else sd, path)
    loaded = Predictor.from_torch_checkpoint(str(path), predictor.config, device="cpu")
    imgs, pts, pv = _frames(rng, 2)
    np.testing.assert_array_equal(loaded(imgs, pts, pv).numpy(),
                                  predictor(imgs, pts, pv).numpy())
