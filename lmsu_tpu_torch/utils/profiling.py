"""Profiling and throughput instrumentation: a step timer, an input-stall
meter and a torch.profiler trace context.

Counterpart of lmsu_tpu/utils/profiling.py. `aot_compile_with_cost` has no
counterpart: it is XLA's ahead-of-time compile and cost analysis, which
only the JAX package's benchmark files call.

    timer = StepTimer(warmup_steps=1, device=torch.device("cuda"))
    for batch in loader:
        with timer:
            trainer.train_step(batch)
    timer.summary(batch_size=128)   # steps, mean_ms, p50_ms, p95_ms, frames_per_sec

    meter = StallMeter(loader)
    for batch in meter: ...
    meter.stall_frac                 # share of the loop spent waiting on next(loader)

    with profiler_trace("trace_dir"):
        ...                          # trace_dir/trace.json (Chrome trace)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from lmsu_tpu_torch.common import OUTPUT_ROOT


class StepTimer:
    """Tracks step wall time and frames/sec with a warm-up skip.

    The JAX timer relies on each wrapped step waiting for its loss. The
    port's train step reads nothing back (the loss and the confusion matrix
    stay on the device until the epoch's end), so on a CUDA device a timer
    that does not synchronise measures only the enqueue of the step's
    kernels. Given `device` (a CUDA device), the timer synchronises it at
    `__enter__` and `__exit__`, so each interval is the step's whole time on
    the card. Without it (the default) it synchronises nothing, as the JAX
    timer, which is right on the CPU, where every op runs before it
    returns."""

    def __init__(self, warmup_steps: int = 1, device: Optional[torch.device] = None):
        self.warmup_steps = warmup_steps
        self.device = device
        self._times: list = []
        self._count = 0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "StepTimer":
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup_steps:
            self._times.append(dt)

    def summary(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self._times:
            return {}
        times = np.asarray(self._times)
        out = {
            "steps": len(times),
            "mean_ms": float(times.mean() * 1e3),
            "p50_ms": float(np.median(times) * 1e3),
            "p95_ms": float(np.percentile(times, 95) * 1e3),
        }
        if batch_size:
            out["frames_per_sec"] = float(batch_size / times.mean())
        return out


class StallMeter:
    """Wraps a batch iterable, separating the time spent waiting on the host
    input pipeline (next(loader)) from the rest of the loop.

    The wait is genuine input stall where the loop's steps take the
    producer's whole step time to decode ahead; stall_frac ~ 0 means
    decoding hides behind the steps. `total_s` is set when the iteration
    ends, also on an early exit (an exception from the loader or the
    consumer, a break, `close()`), so a caller that reads stall_frac in its
    own `finally` sees the partial epoch's share, not 0."""

    def __init__(self, iterable):
        self.iterable = iterable
        self.wait_s = 0.0
        self.total_s = 0.0
        self.batches = 0

    @property
    def stall_frac(self) -> float:
        return self.wait_s / self.total_s if self.total_s else 0.0

    def __iter__(self):
        start = time.perf_counter()
        it = iter(self.iterable)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self.wait_s += time.perf_counter() - t0
                self.batches += 1
                yield item
        finally:
            self.total_s = time.perf_counter() - start


@contextlib.contextmanager
def profiler_trace(log_dir: str = os.path.join(OUTPUT_ROOT, "trace")
                   ) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the block (CPU activity, and the
    CUDA device's where one is available) and export it as a Chrome trace,
    `log_dir`/trace.json (view it in Perfetto or chrome://tracing). Yields
    the profiler, whose key_averages() the caller may read after the
    block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
