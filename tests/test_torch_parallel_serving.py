"""Data-parallel serving and the multi-process KD run, on the CPU.

ServingEngine.from_predictor(devices=[...]) (one replica a device, each
batch split evenly, the logits gathered; the JAX package's mesh serving):
on devices ["cpu", "cpu"] it equals the port's one-device engine within
1e-5 of scale with argmax equal, and the JAX engine on a 2-device mesh
(tests/conftest.py's CPU devices) within the parity bar, 5e-4 of scale, on
tests/test_torch_frozen.py's weights (randomised BN statistics). The JAX
package's refusals, a weight swap that reaches every replica, and the
serve CLI's --data-parallel. Then `python -m
lmsu_tpu_torch.run_multiprocess --device cpu --num-processes 2` (the fsdp
teacher, the sorted scatter, the host teacher cache) passes.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_frozen import IMG, NPTS, configs, frames, state_dict

from lmsu_tpu_torch import serve
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

B = 4


def _serve(engine, imgs, pts, pv):
    try:
        futs = [engine.submit(i, p, v) for i, p, v in zip(imgs, pts, pv)]
        return np.stack([f.result(timeout=120) for f in futs])
    finally:
        engine.close()


def _port_engine(devices=None, **kw):
    _, pcfg = configs(True)
    pred = Predictor(pcfg, state_dict(), device="cpu")
    return ServingEngine.from_predictor(pred, batch_size=B, image_size=(IMG, IMG),
                                        num_points=NPTS, max_delay_ms=50.0, devices=devices,
                                        **kw)


def test_data_parallel_engine_matches_one_device_and_jax_mesh():
    from lmsu_tpu.inference import Predictor as JaxPredictor
    from lmsu_tpu.serving.engine import ServingEngine as JaxEngine
    from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
    imgs, pts, pv = frames(4, n=B)
    one = _serve(_port_engine(), imgs, pts, pv)
    dp_engine = _port_engine(devices=["cpu", "cpu"])
    assert dp_engine.batch_size == B
    dp = _serve(dp_engine, imgs, pts, pv)
    scale = np.abs(one).max()
    assert scale > 0.1 and np.abs(dp - one).max() <= 1e-5 * scale
    assert (dp.argmax(-1) == one.argmax(-1)).all()
    jcfg, _ = configs(False)
    jpred = JaxPredictor(jcfg, convert_torch_state_dict(state_dict(), jcfg))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    with jax.default_matmul_precision("highest"):
        want = _serve(JaxEngine.from_predictor(jpred, batch_size=B, image_size=(IMG, IMG),
                                               num_points=NPTS, max_delay_ms=50.0, mesh=mesh),
                      imgs, pts, pv)
    assert np.abs(dp - want).max() <= 5e-4 * np.abs(want).max()


def test_data_parallel_refusals_and_swap():
    """Batch sizes that do not divide by the device count and batches
    without point_valid are refused in the JAX package's words; a swap
    reaches every replica; a frozen Predictor refuses it."""
    for kw in (dict(batch_size=3), dict(batch_size=None, batch_sizes=[2, 3])):
        _, pcfg = configs(True)
        pred = Predictor(pcfg, state_dict(), device="cpu")
        with pytest.raises(ValueError, match="must be divisible by the mesh device count 2"):
            ServingEngine.from_predictor(pred, image_size=(IMG, IMG), num_points=NPTS,
                                         devices=["cpu", "cpu"], **kw)
    eng = _port_engine(devices=["cpu", "cpu"])
    try:
        imgs, pts, pv = frames(5, n=B)
        with pytest.raises(ValueError, match="requires point_valid"):
            eng._forward(imgs, pts, None)
        other = Predictor(configs(True)[1], device="cpu", seed=7)
        eng.swap_variables(other.model.state_dict())
        got = _to_np(eng._forward(imgs, pts, pv))
    finally:
        eng.close()
    want = other.forward_batch(imgs, pts, pv).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    _, pcfg = configs(True)
    frozen = Predictor(pcfg, state_dict(), device="cpu", freeze_weights=True)
    eng = ServingEngine.from_predictor(frozen, batch_size=B, image_size=(IMG, IMG),
                                       num_points=NPTS, devices=["cpu", "cpu"])
    try:
        with pytest.raises(RuntimeError, match="baked"):
            eng.swap_variables(state_dict())
    finally:
        eng.close()


def _to_np(t):
    return t.detach().float().numpy()


def test_serve_cli_data_parallel(monkeypatch, capsys):
    """--data-parallel 2 --device cpu builds two replicas; more replicas
    than visible CUDA devices exits with the JAX script's message; an
    artifact is refused."""
    args = serve.parse_args(["--device", "cpu", "--image-size", "32", "32", "--num-points",
                             "64", "--batch-size", "2", "--data-parallel", "2"])
    eng = serve.build_engine(args)
    try:
        rng = np.random.default_rng(0)
        out = eng.predict(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                          rng.normal(0, 20, (64, 4)).astype(np.float32),
                          np.ones(64, bool), timeout=120)
    finally:
        eng.close()
    assert out.shape == (8, 8, 2) and np.isfinite(out).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(serve, "load_predictor", lambda args, cfg: None)
    with pytest.raises(SystemExit, match="--data-parallel 2 but only 1 devices visible"):
        serve.build_engine(serve.parse_args(["--data-parallel", "2"]))
    with pytest.raises(SystemExit, match="not an --artifact"):
        serve.build_engine(serve.parse_args(["--artifact", "x.pt2", "--data-parallel", "2"]))


def test_run_multiprocess_two_ranks_on_cpu(capsys):
    from lmsu_tpu_torch import run_multiprocess
    summary = run_multiprocess.main(["--device", "cpu", "--num-processes", "2",
                                     "--teacher-partition", "fsdp",
                                     "--scatter-impl", "sorted_pallas", "--timeout", "240"])
    assert summary["num_stripes"] == 2 and summary["backend"] == "gloo"
    assert summary["stripes_disjoint_and_complete"] and summary["host_spill_teacher_cache"]
    assert summary["teacher_bytes_per_rank"] < 0.55 * summary["teacher_bytes_full"]
    assert all(v["err"] <= v["tol"] for v in summary["held_to_reference"].values())
