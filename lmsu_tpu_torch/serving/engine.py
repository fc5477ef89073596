"""Dynamic-batching serving engine of the PyTorch port.

Counterpart of lmsu_tpu/serving/engine.py, with the same design:

- **Fixed batch shapes.** The batch shape [B, H, W, 3] / [B, N, 4] is fixed
  at construction (or a short ladder of batch sizes); partial batches are
  zero-padded and the pad rows' outputs dropped, so the device sees a
  finite set of shapes.
- **Dynamic micro-batching.** Requests queue; a dispatcher thread opens a
  batching window when the first request lands and closes it after
  `max_delay_ms` or when `batch_size` requests are waiting, whichever is
  first. Latency cost is bounded by the window.
- **Async-dispatch pipelining.** CUDA launches are non-blocking: the
  dispatcher enqueues the forward and returns to stacking the next batch,
  while a completer thread copies the logits to the host (the copy is
  where it waits for the device) and resolves client futures.
  `max_inflight` bounds the device queue depth.
- **Per-request host work stays on client threads.** Point padding /
  deterministic subsampling / the sorted-scatter cell sort run in
  `submit()` on the caller's thread, so N clients parallelize the host
  preprocessing instead of serializing it behind the dispatcher.

Backends: any callable `(images, points, point_valid) -> logits` returning a
torch tensor (on any device) or an array; `from_predictor` wraps the port's
Predictor (frozen or not, float or int8), on its device or data-parallel
over several (`devices`: a replica a device, each batch split evenly and
the logits gathered), `from_exported` a Predictor.export() artifact.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _on(device: torch.device):
    """The device's CUDA context for launches (a no-op elsewhere)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class EngineOverloaded(RuntimeError):
    """Raised by submit()/predict() when the request queue is at
    max_queue: shed load at the edge instead of growing host memory
    without bound. The HTTP front-end maps this to 503."""


def _to_host(logits) -> np.ndarray:
    """Device logits -> numpy (bf16 widens to float32: numpy has no bf16).
    For a CUDA tensor this copy is where the host waits for the device."""
    if hasattr(logits, "detach"):
        t = logits.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(logits)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q / 100.0 * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


class _Pending:
    __slots__ = ("image", "points", "point_valid", "future", "t_enqueue")

    def __init__(self, image, points, point_valid):
        self.image = image
        self.points = points
        self.point_valid = point_valid
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


class ServingEngine:
    """Dynamic-batching inference engine over a fixed-shape forward.

    forward: callable (images [B,H,W,3], points [B,N,4], point_valid [B,N]
        bool) -> logits [B,h,w,C]; must accept exactly the constructed
        batch shape. from_predictor builds it for a Predictor.
    batch_size: batch size B. Partial windows are padded to B.
    batch_sizes: optional ladder of batch sizes (e.g. (1, 8, 32)); the
        dispatcher pads each window to the smallest rung that fits, so a
        lone request rides a B=1 forward instead of paying a full max-B
        pad transfer. When given, batch_size is ignored and the largest
        rung is the window bound.
    image_size: (H, W) of the input.
    num_points: N of the point dimension; requests are padded
        (point_valid False on pads) or deterministically stride-subsampled
        down to it.
    max_delay_ms: batching window — the max extra latency a request pays
        waiting for co-batched requests.
    max_inflight: device-queue depth (batches dispatched but not yet
        retrieved). 2 = classic double buffering.
    image_dtype: np.uint8 (default; 4x cheaper host->device, the model
        normalizes on device — models/fusion.py) or np.float32.
        float inputs are assumed [0,1] and converted losslessly only
        to float32.
    passes_point_valid: False for backends exported without the mask
        input (Predictor.export(with_point_valid=False)): the forward then
        gets None for it.
    sorter: optional per-sample dict transform (the sorted-scatter cell
        sort, data/rasterize.py::make_point_sorter) applied in submit().
    latency_window: the last requests whose latencies stats() summarises.
    """

    def __init__(self, forward: Callable, *, batch_size: Optional[int] = None,
                 image_size=(256, 256), num_points: int = 5000,
                 max_delay_ms: float = 2.0, max_inflight: int = 2,
                 image_dtype=np.uint8, passes_point_valid: bool = True,
                 sorter: Optional[Callable] = None,
                 latency_window: int = 4096,
                 max_queue: int = 0,
                 batch_sizes: Optional[Sequence[int]] = None):
        self._forward = forward
        if batch_sizes is None:
            if batch_size is None:
                raise ValueError("pass batch_size or batch_sizes")
            batch_sizes = [batch_size]
        rungs = sorted({int(b) for b in batch_sizes})
        if not rungs or rungs[0] < 1:
            raise ValueError(f"invalid batch_sizes {rungs}")
        self.batch_sizes = tuple(rungs)
        self.batch_size = rungs[-1]
        self.image_size = tuple(image_size)
        self.num_points = int(num_points)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.image_dtype = np.dtype(image_dtype)
        self.passes_point_valid = passes_point_valid
        self._sorter = sorter
        self._latency_window = int(latency_window)

        # max_queue > 0 bounds admitted-but-undispatched requests; at the
        # bound submit() raises EngineOverloaded (load shedding) rather
        # than buffering frames without limit. 0 = unbounded (library
        # default; the HTTP server sets a bound).
        self.max_queue = int(max_queue)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue(maxsize=max(1, max_inflight))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded_rows = 0
        self._n_slot_rows = 0  # sum of dispatched rung sizes
        self._batches_by_size = {}
        self._latencies = []  # seconds, the last latency_window requests
        self._t_first = None
        self._t_last = None

        self._swap = None  # set by from_predictor unless the weights are frozen

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="serving-complete", daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_predictor(cls, predictor, *, batch_size: Optional[int] = None,
                       max_delay_ms: float = 2.0, devices: Optional[Sequence] = None,
                       **kw) -> "ServingEngine":
        """Serve a lmsu_tpu_torch.inference.Predictor on its device, or
        data-parallel over `devices` (the JAX package's mesh serving).

        The engine bypasses Predictor.__call__'s per-call host sort and
        instead applies the same sorter per-sample on client threads.

        devices: one replica of the model on each (Predictor.replica); every
        batch is split evenly over them, each chunk launched on its device
        (CUDA launches do not wait, so the devices overlap), and the logits
        gathered on the first. Each batch size must divide by the device
        count, and batches must carry point_valid, as in the JAX package.

        Unless the Predictor is frozen (freeze_weights=True), the returned
        engine supports swap_variables(state_dict): the new weights are
        copied into the live model (every replica's) under a lock that the
        dispatcher also holds while it enqueues a forward, so every batch
        sees one consistent set (the copy is queued on the same stream as
        the forwards, so ordering holds on the device too).
        """
        lock = threading.Lock()
        if devices is None:
            replicas = [predictor]

            def forward(images, points, point_valid):
                with lock:
                    return predictor.forward_batch(images, points, point_valid)
        else:
            n_dev = len(devices)
            if n_dev < 1:
                raise ValueError("devices must name at least one device")
            for b in (kw.get("batch_sizes") or [batch_size]):
                if b is None or b % n_dev:
                    raise ValueError(f"batch size {b} must be divisible by the "
                                     f"mesh device count {n_dev}")
            replicas = [predictor.replica(d) for d in devices]

            def forward(images, points, point_valid):
                if point_valid is None:
                    raise ValueError("mesh serving requires point_valid batches "
                                     "(passes_point_valid=True)")
                L = len(images) // n_dev
                outs = []
                with lock:
                    for i, rep in enumerate(replicas):
                        rows = slice(i * L, (i + 1) * L)
                        with _on(rep.device):
                            outs.append(rep.forward_batch(images[rows], points[rows],
                                                          point_valid[rows]))
                first = replicas[0].device
                return torch.cat([o.to(first, non_blocking=True) for o in outs])

        def swap(state_dict):
            with lock, torch.no_grad():
                for rep in replicas:
                    rep.model.load_state_dict(state_dict, strict=True)

        eng = cls(forward, batch_size=batch_size, max_delay_ms=max_delay_ms,
                  sorter=predictor._sorter, **kw)
        if not predictor._freeze_weights:
            eng._swap = swap
        return eng

    @classmethod
    def from_exported(cls, path: str, *, batch_size: int, num_points: int = 5000,
                      image_size=(256, 256), with_point_valid: bool = True,
                      max_delay_ms: float = 2.0, device=None, **kw) -> "ServingEngine":
        """Serve a Predictor.export() artifact (no model code).

        batch_size / num_points / image_size / with_point_valid must match
        the exported specs (torch.export fixes them when it traces), and
        the artifact takes float32 images. It runs on the device it was
        exported on; `device`, when given, must be that one. Where the
        artifact's scatter needs cell-sorted points (scatter_impl
        "sorted_pallas", recorded in the artifact), the engine sorts them on
        the request threads, as it does for a Predictor.
        """
        if kw.get("batch_sizes"):
            raise ValueError(
                "exported artifacts are single-shape; the batch-size "
                "ladder needs a Predictor backend (or one artifact per "
                "rung wired through a custom forward)")
        from lmsu_tpu_torch.data.rasterize import make_point_sorter
        from lmsu_tpu_torch.inference import load_exported
        call = load_exported(path)
        meta = call.meta
        want = {"batch_size": batch_size, "num_points": num_points,
                "image_size": list(image_size), "with_point_valid": with_point_valid}
        got = {k: meta[k] for k in want}
        if got != want:
            raise ValueError(f"artifact {path} was exported for {got}, not {want}")
        if device is not None and torch.device(device).type != call.device.type:
            raise ValueError(f"artifact {path} runs on {call.device.type}, not {device}")
        if meta["scatter_impl"] == "sorted_pallas":
            kw.setdefault("sorter", make_point_sorter(tuple(meta["grid_size"]),
                                                      tuple(meta["point_cloud_range"])))
        kw.setdefault("image_dtype", np.float32)
        return cls(call, batch_size=batch_size, num_points=num_points,
                   image_size=image_size, max_delay_ms=max_delay_ms,
                   passes_point_valid=with_point_valid, **kw)

    # -- client API --------------------------------------------------------

    def submit(self, image, points, point_valid=None) -> Future:
        """Enqueue one frame; returns a Future resolving to logits
        [h, w, num_classes] (numpy). Thread-safe; preprocessing (dtype,
        point padding/subsample, optional cell sort) runs on the calling
        thread."""
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is closed")
        if self.max_queue and self._queue.qsize() >= self.max_queue:
            raise EngineOverloaded(
                f"request queue at max_queue={self.max_queue}; retry later")
        image = self._prep_image(image)
        points, point_valid = self._prep_points(points, point_valid)
        pending = _Pending(image, points, point_valid)
        with self._lock:
            self._n_requests += 1
            if self._t_first is None:
                self._t_first = pending.t_enqueue
        self._queue.put(pending)
        return pending.future

    def predict(self, image, points, point_valid=None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous single-frame logits."""
        return self.submit(image, points, point_valid).result(timeout)

    def predict_mask(self, image, points, point_valid=None,
                     timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous single-frame argmax mask [h, w] int32."""
        logits = self.predict(image, points, point_valid, timeout)
        return np.argmax(logits, axis=-1).astype(np.int32)

    def warmup(self) -> None:
        """Run every batch-size rung once up front (kernel builds, cuDNN
        algorithm selection and allocator growth happen here instead of on
        first use), then reset the stats counters so warm-up latencies
        don't poison p95/p99/throughput."""
        for b in self.batch_sizes:
            zi = np.zeros((b, *self.image_size, 3), self.image_dtype)
            zp = np.zeros((b, self.num_points, 4), np.float32)
            pv = (np.zeros((b, self.num_points), bool)
                  if self.passes_point_valid else None)
            _to_host(self._forward(zi, zp, pv))
        # one request through the full path (queue/dispatch/complete)
        self.predict(np.zeros((*self.image_size, 3), self.image_dtype),
                     np.zeros((self.num_points, 4), np.float32),
                     np.zeros((self.num_points,), bool))
        self.reset_stats()

    def swap_variables(self, state_dict) -> None:
        """Hot-swap the serving weights (a state dict of the served model),
        so a training loop can push each new checkpoint into a live engine.
        The swap is atomic at batch granularity. Unavailable for frozen or
        exported backends (their weights are baked into the served copy or
        the artifact) and for a bare forward callable."""
        if self._swap is None:
            raise RuntimeError(
                "this engine's backend has weights baked into the "
                "served model (freeze_weights/exported) or is a bare forward "
                "callable; rebuild the engine to change them")
        self._swap(state_dict)

    def reset_stats(self) -> None:
        with self._lock:
            self._n_requests = 0
            self._n_batches = 0
            self._n_padded_rows = 0
            self._n_slot_rows = 0
            self._batches_by_size = {}
            self._latencies = []
            self._t_first = None
            self._t_last = None

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            n_req, n_b = self._n_requests, self._n_batches
            n_pad, n_slots = self._n_padded_rows, self._n_slot_rows
            by_size = dict(self._batches_by_size)
            t0, t1 = self._t_first, self._t_last
        span = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        occupancy = (n_slots - n_pad) / max(1, n_slots)
        return {
            "requests": n_req,
            "batches": n_b,
            "batch_size": self.batch_size,
            "batch_sizes": list(self.batch_sizes),
            "batches_by_size": by_size,
            "occupancy": round(occupancy, 4),
            "throughput_rps": round(n_req / span, 2) if span > 0 else None,
            "latency_ms": {
                "p50": round(_percentile(lat, 50) * 1e3, 3),
                "p95": round(_percentile(lat, 95) * 1e3, 3),
                "p99": round(_percentile(lat, 99) * 1e3, 3),
                "mean": round(float(np.mean(lat)) * 1e3, 3) if lat else None,
            },
        }

    def close(self, timeout: float = 10.0) -> None:
        """Drain and stop. Queued requests are completed first; if the
        dispatcher cannot drain within `timeout` (e.g. a stalled device
        forward), remaining futures are failed with RuntimeError instead
        of being silently abandoned."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._queue.put(None)  # wake the dispatcher
        self._dispatcher.join(timeout)
        if not self._dispatcher.is_alive():
            # Clean drain: the completer sentinel lands AFTER every
            # dispatched batch (FIFO), so all in-flight futures resolve
            # before it exits.
            self._done.put(None)
            self._completer.join(timeout)
        # Fail anything left behind: requests that raced past the _stop
        # check in submit() after the dispatcher exited, or everything
        # still queued when the dispatcher failed to drain in time.
        leftovers = []
        try:
            while True:
                item = self._queue.get_nowait()
                if item is not None:
                    leftovers.append(item)
        except queue.Empty:
            pass
        for req in leftovers:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    RuntimeError("ServingEngine closed before this "
                                 "request was dispatched"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- preprocessing (client threads) -------------------------------------

    def _prep_image(self, image) -> np.ndarray:
        img = np.asarray(image)
        if img.shape != (*self.image_size, 3):
            raise ValueError(f"image shape {img.shape} != "
                             f"{(*self.image_size, 3)}")
        if img.dtype == self.image_dtype:
            return img
        if img.dtype == np.uint8 and self.image_dtype == np.float32:
            return img.astype(np.float32) / 255.0
        if self.image_dtype == np.uint8:
            raise ValueError(
                f"engine built for uint8 images, got {img.dtype}; "
                "pass uint8 or build the engine with image_dtype=float32")
        return img.astype(self.image_dtype)

    def _prep_points(self, points, point_valid):
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2 or pts.shape[1] != 4:
            raise ValueError(f"points must be [N, 4], got {pts.shape}")
        n = pts.shape[0]
        if point_valid is None:
            pv = np.ones((n,), bool)
        else:
            pv = np.asarray(point_valid, bool)
            if pv.shape != (n,):
                raise ValueError("point_valid must be [N] matching points")
        if n > self.num_points:
            # Deterministic even-stride subsample (serving must be
            # reproducible; the reference's random downsample,
            # pandaset_dataset.py:121-127, is a *training* choice).
            idx = np.linspace(0, n - 1, self.num_points).round().astype(np.int64)
            pts, pv = pts[idx], pv[idx]
        elif n < self.num_points:
            pad = self.num_points - n
            pts = np.concatenate([pts, np.zeros((pad, 4), np.float32)])
            pv = np.concatenate([pv, np.zeros((pad,), bool)])
        if self._sorter is not None:
            s = self._sorter({"points": pts, "point_valid": pv})
            pts, pv = s["points"], s["point_valid"]
        return pts, pv

    # -- dispatcher / completer threads --------------------------------------

    def _collect_window(self):
        """Block for the first request, then fill until batch_size or the
        max_delay deadline. Returns [] only at shutdown."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        window = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(window) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            window.append(nxt)
        return window

    def _dispatch_loop(self):
        while True:
            window = self._collect_window()
            if not window:
                if self._stop.is_set() and self._queue.empty():
                    return
                continue
            # Transition futures to RUNNING; a client that already
            # cancelled drops out here, and nobody can cancel past this
            # point — so the completer's set_result cannot race a
            # cancellation (an uncaught InvalidStateError there would
            # kill the completer thread and wedge the whole engine).
            window = [r for r in window
                      if r.future.set_running_or_notify_cancel()]
            if not window:
                continue
            n = len(window)
            # Smallest ladder rung that fits: a lone request pays a B=1
            # transfer+forward, a burst rides the big batch.
            B = next(b for b in self.batch_sizes if b >= n)
            images = np.zeros((B, *self.image_size, 3), self.image_dtype)
            points = np.zeros((B, self.num_points, 4), np.float32)
            pvalid = np.zeros((B, self.num_points), bool)
            for i, req in enumerate(window):
                images[i] = req.image
                points[i] = req.points
                pvalid[i] = req.point_valid
            try:
                pv_arg = pvalid if self.passes_point_valid else None
                logits = self._forward(images, points, pv_arg)
            except Exception as e:  # resolve, don't kill the loop
                for req in window:
                    req.future.set_exception(e)
                continue
            with self._lock:
                self._n_batches += 1
                self._n_padded_rows += B - n
                self._n_slot_rows += B
                self._batches_by_size[B] = self._batches_by_size.get(B, 0) + 1
            # Hand off to the completer; CUDA launches are async, so this
            # thread immediately returns to stacking the next window while
            # the device crunches this one.
            self._done.put((window, logits))

    def _complete_loop(self):
        while True:
            item = self._done.get()
            if item is None:
                return
            window, logits = item
            try:
                host = _to_host(logits)  # blocks until device done
            except Exception as e:
                for req in window:
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            t = time.monotonic()
            lats = []
            for i, req in enumerate(window):
                req.future.set_result(host[i].copy())
                lats.append(t - req.t_enqueue)
            with self._lock:
                self._t_last = t
                self._latencies.extend(lats)
                if len(self._latencies) > self._latency_window:
                    del self._latencies[:-self._latency_window]
