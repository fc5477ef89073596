"""The port's profiling utilities (lmsu_tpu_torch/utils/profiling.py) and
SegmentationMetrics (ops/metrics.py) against the JAX package's, on the CPU:
StepTimer and StallMeter on one patched clock (a slow producer, an early
exit), profiler_trace writing a Chrome trace, the trainer's input-stall
share on an epoch that an exception cuts short, and the metrics
accumulator exactly."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import ExperimentConfig as JExperimentConfig
from lmsu_tpu.ops.metrics import SegmentationMetrics as JSegmentationMetrics
from lmsu_tpu.training import trainer as jax_trainer
from lmsu_tpu.utils import profiling as jprof
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   LidarEncoderConfig, ModelConfig, TrainConfig)
from lmsu_tpu_torch.ops import SegmentationMetrics
from lmsu_tpu_torch.training import Trainer
from lmsu_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)


class FakeClock:
    """time.perf_counter for both packages: it moves only when told."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def _timed_steps(timer_cls, clock, durations, **kw):
    timer = timer_cls(warmup_steps=2, **kw)
    for d in durations:
        with timer:
            clock.t += d
    return timer.summary(batch_size=16)


def test_step_timer_summary_matches_jax(clock):
    """The same warm-up skip and summary keys and values on one clock; no
    step after the warm-up gives {}; on the CPU the device argument syncs
    nothing."""
    durations = [0.5, 0.4, 0.010, 0.012, 0.011, 0.030, 0.009]
    want = _timed_steps(jprof.StepTimer, clock, durations)
    assert set(want) == {"steps", "mean_ms", "p50_ms", "p95_ms", "frames_per_sec"}
    assert _timed_steps(prof.StepTimer, clock, durations) == want
    assert _timed_steps(prof.StepTimer, clock, durations, device=torch.device("cpu")) == want
    assert _timed_steps(prof.StepTimer, clock, durations[:2]) == \
        _timed_steps(jprof.StepTimer, clock, durations[:2]) == {}
    t = prof.StepTimer(warmup_steps=0)
    with t:
        clock.t += 0.25
    assert t.summary() == {"steps": 1, "mean_ms": 250.0, "p50_ms": 250.0, "p95_ms": 250.0}


def test_step_timer_synchronises_the_given_cuda_device(monkeypatch):
    """With a CUDA device the timer synchronises it at enter and exit (the
    port's train step reads nothing back, so without it a timer measures
    only the enqueue); without one it never does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    dev = torch.device("cuda", 0)
    with prof.StepTimer(device=dev):
        pass
    assert calls == [dev, dev]
    with prof.StepTimer():
        pass
    assert len(calls) == 2


def _metered(meter_cls, clock, n=4, raise_at=None, break_at=None, wait=0.03, step=0.01):
    """A producer taking `wait` a batch and a consumer taking `step`; the
    producer raises at batch `raise_at`, the consumer breaks at `break_at`."""
    def producer():
        for i in range(n):
            clock.t += wait
            if i == raise_at:
                raise RuntimeError("loader died")
            yield i

    m = meter_cls(producer())
    try:
        for i in m:
            clock.t += step
            if i == break_at:
                break
    except RuntimeError:
        pass
    return m


@pytest.mark.parametrize("case", [{}, {"raise_at": 2}, {"break_at": 1}],
                         ids=["whole", "loader_raises", "consumer_breaks"])
def test_stall_meter_matches_jax(clock, case):
    """The same accounting on one clock, also when the producer raises or
    the consumer breaks: total_s is set on the early exit (a consumer's
    break closes the generator in both packages when it is dropped), so the
    share is the partial epoch's, not 0."""
    got, want = _metered(prof.StallMeter, clock, **case), _metered(jprof.StallMeter, clock, **case)
    got_v = (got.batches, got.wait_s, got.total_s, got.stall_frac)
    assert got_v == pytest.approx((want.batches, want.wait_s, want.total_s, want.stall_frac),
                                  rel=1e-12, abs=1e-12)
    assert 0.0 < got.stall_frac < 1.0 and got.total_s > 0


def test_stall_meter_slow_producer_real_clock():
    """tests/test_multichip.py's slow producer on the real clock."""
    def slow_producer():
        for i in range(3):
            time.sleep(0.02)
            yield i

    m = prof.StallMeter(slow_producer())
    for _ in m:
        time.sleep(0.01)
    assert m.batches == 3 and 0.0 < m.stall_frac < 1.0 and m.wait_s >= 0.05


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = tmp_path / "trace"
    with prof.profiler_trace(str(d)) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((d / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in p.key_averages())


# -- the trainer's input stall on an epoch an exception cuts short ------------

IMG, GRID, NPTS, B = 64, (16, 16), 64, 2


def _batch(rng):
    return {"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
            "points": rng.normal(0, 20, (B, NPTS, 4)).astype(np.float32),
            "segmentation": rng.integers(0, 2, (B, *GRID)),
            "sample_mask": np.ones(B, bool)}


class SlowThenBrokenLoader:
    """One batch after a 50 ms wait, then a loader error."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 2

    def __iter__(self):
        time.sleep(0.05)
        yield self.batch
        raise RuntimeError("loader died")


@pytest.mark.parametrize("scan_steps", [1, 2], ids=["host_loop", "chunked"])
def test_stall_share_is_set_when_the_epoch_is_cut_short(scan_steps, monkeypatch):
    """A loader that raises after a slow batch: the port's trainer writes the
    partial epoch's share in a finally, as the JAX trainer does (before,
    it kept the previous epoch's value, 0 here). The JAX trainer's own
    epoch runs the same loader with its step stubbed (nothing compiles);
    both shares are positive. With --scan-steps 2 the slow batch waits for
    its chunk when the loader dies."""
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
                          camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=8),
                          lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                   grid_size=GRID)),
        data=DataConfig(image_size=(IMG, IMG), grid_size=GRID, max_points=NPTS),
        train=TrainConfig(scan_steps=scan_steps, class_weights=(0.4, 3.5)))
    loader = SlowThenBrokenLoader(batch)
    tr = Trainer(cfg, loader, [], device="cpu")
    with pytest.raises(RuntimeError, match="loader died"):
        tr.train_epoch()
    assert 0.0 < tr.last_host_stall_frac < 1.0

    jt = object.__new__(jax_trainer.Trainer)
    jt.config = JExperimentConfig()
    jt.mesh, jt.state = None, None
    jt.train_step = lambda state, b: (state, jnp.zeros(()), np.zeros((2, 2), np.int64))
    jt.last_host_stall_frac = 0.0
    monkeypatch.setattr(jax_trainer, "shard_batch", lambda b, mesh: b)
    with pytest.raises(RuntimeError, match="loader died"):
        jt._run_epoch(SlowThenBrokenLoader(batch), True)
    assert 0.0 < jt.last_host_stall_frac < 1.0


def test_stall_share_is_set_when_the_step_raises(monkeypatch):
    """A step that raises: closing the meter sets its total before the
    share is read, so the share is the partial epoch's."""
    rng = np.random.default_rng(1)

    def loader():
        time.sleep(0.05)
        yield _batch(rng)

    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="minimal", fusion_out_channels=16,
                          camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=8),
                          lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                   grid_size=GRID)),
        data=DataConfig(image_size=(IMG, IMG), grid_size=GRID, max_points=NPTS))
    tr = Trainer(cfg, [None], [], device="cpu")

    def broken(batch):
        raise FloatingPointError("NaN guard")
    monkeypatch.setattr(tr, "train_step", broken)
    with pytest.raises(FloatingPointError):
        tr._run_epoch(loader(), train=True)
    assert 0.0 < tr.last_host_stall_frac <= 1.0


# -- SegmentationMetrics ------------------------------------------------------

def test_segmentation_metrics_match_jax_exactly():
    """reset / update / update_confusion / compute against the JAX class:
    random logits, ignore_index, labels out of range (negative and >= C),
    a confusion matrix added directly; the counts and the IoU dicts equal."""
    rng = np.random.default_rng(7)
    C = 3
    got, want = SegmentationMetrics(C, ignore_index=-1), JSegmentationMetrics(C, ignore_index=-1)
    for _ in range(3):
        logits = rng.normal(size=(2, 8, 8, C)).astype(np.float32)
        targets = rng.integers(-2, C + 2, (2, 8, 8))
        got.update(torch.from_numpy(logits), torch.from_numpy(targets))
        want.update(logits, targets)
    cm = rng.integers(0, 50, (C, C))
    got.update_confusion(torch.from_numpy(cm))
    want.update_confusion(cm)
    assert got.confusion.dtype == np.int64
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.compute() == want.compute()
    got.reset()
    want.reset()
    assert got.compute() == want.compute() and not got.confusion.any()
    ignore7 = SegmentationMetrics(2, ignore_index=7)
    j7 = JSegmentationMetrics(2, ignore_index=7)
    logits = rng.normal(size=(4, 16, 2)).astype(np.float32)
    targets = rng.choice([0, 1, 7, -1], (4, 16))
    ignore7.update(logits, targets)
    j7.update(logits, targets)
    np.testing.assert_array_equal(ignore7.confusion, j7.confusion)
    assert ignore7.compute() == j7.compute()


def test_ops_exports_the_metrics_and_registers_the_serving_operators():
    import lmsu_tpu_torch.ops as ops
    assert {"SegmentationMetrics", "confusion_matrix", "iou_from_confusion"} <= set(ops.__all__)
    for name in ("segment_max", "segment_max_flat", "scatter_max", "fusion_gate",
                 "fused_ir_infer"):
        assert hasattr(torch.ops.lmsu_tpu_torch, name), name
