"""Load-benchmark the serving engine: latency and throughput against
concurrency, on the card.

Counterpart of scripts/bench_serving.py. Closed-loop load against an
in-process ServingEngine (the HTTP layer is stdlib plumbing; this measures
the engine and the device): C client threads each submit single frames
back to back for --duration seconds, and the engine micro-batches them
into the fixed-shape forward. Reports p50/p95/p99 request latency,
throughput and batch occupancy per concurrency level; optionally a soak, an
open-loop saturation run (producer threads, shedding at --max-queue) and a
null backend (a host sleep of --null-backend-ms a batch) that isolates the
engine's software ceiling. Every request draws from a pool of distinct
frames.

On the card the model computes in bf16 unless --fp32, with the serving
cell's kernel opt-ins (scatter_impl sorted_pallas, the fused gate and
fused_inference: K1, K2 and K3); --tiny and the CPU run the plain model in
f32 with the xla scatter.

Usage:
  python -m lmsu_tpu_torch.bench_serving [--device cuda]        # full model
  python -m lmsu_tpu_torch.bench_serving --tiny --device cpu --duration 2
  python -m lmsu_tpu_torch.bench_serving --concurrency 1 32 --baseline-b1

Writes the result line to <output-root>/docs/serving_bench.json (--out),
with `device`: the card's name and power limit, or "cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from lmsu_tpu_torch.common import SCATTER_IMPLS, add_output_root_arg, device_label


def make_frame_pool(rng, n_frames, img_hw, n_pts):
    frames = []
    for _ in range(n_frames):
        img = rng.integers(0, 256, (img_hw, img_hw, 3)).astype(np.uint8)
        pts = rng.normal(0, 25, (n_pts, 4)).astype(np.float32)
        pts[:, 2] = rng.uniform(-5, 3, n_pts)
        pts[:, 3] = rng.uniform(0, 1, n_pts)
        pv = rng.uniform(size=n_pts) > 0.1
        frames.append((img, pts, pv))
    return frames


def run_load(engine, frames, concurrency, duration_s):
    """Closed loop: each of C threads submits a frame, waits, repeats.
    Returns (latencies_s, completed, wall_s, completion_times_s), the
    completion times relative to the load's start."""
    stop = threading.Event()
    lock = threading.Lock()
    all_recs = []
    errors = []
    t_start = time.monotonic()

    def client(tid):
        recs = []
        i = tid  # offset so concurrent batches mix different frames
        try:
            while not stop.is_set():
                img, pts, pv = frames[i % len(frames)]
                i += concurrency
                t0 = time.monotonic()
                engine.predict(img, pts, pv, timeout=600)
                t1 = time.monotonic()
                recs.append((t1 - t0, t1 - t_start))
        except Exception as e:  # surface backend failures, keep data
            with lock:
                errors.append(e)
        finally:
            with lock:
                all_recs.extend(recs)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(concurrency)]
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t_start
    if errors:
        raise RuntimeError(f"{len(errors)} client thread(s) failed during the load run "
                           f"(first: {errors[0]!r}) — results would be corrupted")
    lats = [r[0] for r in all_recs]
    times = [r[1] for r in all_recs]
    return lats, len(lats), wall, times


def run_saturation(engine, frames, duration_s, producers=2, max_outstanding=4096):
    """OPEN-loop burst load: producer threads submit() as fast as the engine
    admits, with no per-request wait, so the dispatcher always has a full
    window (occupancy -> 1.0) and the max_queue shed boundary is exercised.
    Returns (lats, completed, sheds, wall, times)."""
    from lmsu_tpu_torch.serving.engine import EngineOverloaded
    stop = threading.Event()
    sem = threading.Semaphore(max_outstanding)  # bounds outstanding futures
    out_q = queue.Queue()
    lock = threading.Lock()
    recs, sheds = [], [0]
    t_start = time.monotonic()

    def producer(tid):
        i = tid
        while not stop.is_set():
            if not sem.acquire(timeout=0.1):
                continue
            img, pts, pv = frames[i % len(frames)]
            i += producers
            try:
                fut = engine.submit(img, pts, pv)
            except EngineOverloaded:
                sem.release()
                with lock:
                    sheds[0] += 1
                time.sleep(0.002)  # back off, as a client would
                continue
            out_q.put((fut, time.monotonic()))

    def harvester():
        while True:
            item = out_q.get()
            if item is None:
                return
            fut, t0 = item
            fut.result(timeout=600)
            t1 = time.monotonic()
            sem.release()
            with lock:
                recs.append((t1 - t0, t1 - t_start))

    prod = [threading.Thread(target=producer, args=(t,), daemon=True) for t in range(producers)]
    harv = threading.Thread(target=harvester, daemon=True)
    harv.start()
    for t in prod:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in prod:
        t.join(timeout=60)
    # drain: wait for every outstanding future, then stop the harvester
    deadline = time.monotonic() + 600
    while out_q.qsize() > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    out_q.put(None)
    harv.join(timeout=600)
    wall = time.monotonic() - t_start
    lats = [r[0] for r in recs]
    times = [r[1] for r in recs]
    return lats, len(lats), sheds[0], wall, times


def percentiles(lats):
    if not lats:
        return {"p50": None, "p95": None, "p99": None, "p999": None}
    a = np.sort(np.asarray(lats)) * 1e3
    out = {"p50": round(float(np.percentile(a, 50)), 3),
           "p95": round(float(np.percentile(a, 95)), 3),
           "p99": round(float(np.percentile(a, 99)), 3),
           # p999 only meaningful with >=1000 samples; else report max
           "p999": round(float(np.percentile(a, 99.9)), 3) if len(a) >= 1000 else None}
    out["max"] = round(float(a[-1]), 3)
    return out


def serving_model_config(args, on_card: bool):
    """(ModelConfig, image side, points) of the bench: the weighted/128
    student, or --tiny's narrow model; on the card bf16 unless --fp32 and the
    serving cell's kernel opt-ins unless --tiny (--scatter-impl picks the
    scatter in either case)."""
    import dataclasses

    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    dtype = torch.bfloat16 if (on_card and not args.fp32) else torch.float32
    if args.tiny:
        cfg = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
                          camera_fpn_channels=16, compute_dtype=dtype,
                          camera=CameraEncoderConfig(base_channels=8),
                          lidar=LidarEncoderConfig(feature_dim=32, mlp_dims=(16, 32),
                                                   grid_size=(16, 16)))
        img_hw, n_pts = 64, 512
    else:
        cfg = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                          compute_dtype=dtype)
        img_hw, n_pts = 256, 5000
    kernels = on_card and not args.tiny
    scatter = args.scatter_impl or ("sorted_pallas" if kernels else None)
    if scatter:
        cfg = cfg.replace(lidar=dataclasses.replace(cfg.lidar, scatter_impl=scatter))
    if kernels:
        cfg = cfg.replace(use_pallas_fusion=True,
                          camera=dataclasses.replace(cfg.camera, fused_inference=True))
    return cfg, img_hw, n_pts


def build_engine(args, batch_size, batch_sizes=None):
    """(engine, image side, points, on the card, scatter) for the bench's
    Predictor: --checkpoint's weights, else seed 0's."""
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.inference import Predictor, resolve_device
    from lmsu_tpu_torch.serving import ServingEngine

    on_card = resolve_device(args.device).type == "cuda"
    cfg, img_hw, n_pts = serving_model_config(args, on_card)
    weights = load_weights(args.checkpoint, cfg) if args.checkpoint else None
    pred = Predictor(cfg, weights, device=args.device)
    eng = ServingEngine.from_predictor(pred, batch_size=batch_size, batch_sizes=batch_sizes,
                                       image_size=(img_hw, img_hw), num_points=n_pts,
                                       max_delay_ms=args.max_delay_ms, image_dtype=np.uint8)
    return eng, img_hw, n_pts, on_card, cfg.lidar.scatter_impl, cfg


def null_backend(cfg, batch_ms: float):
    """A forward that sleeps `batch_ms` on the host and returns zero logits
    in the port engine's layout: a CPU tensor [B, h, w, num_classes] in the
    compute dtype."""
    h, w = cfg.lidar.grid_size

    def forward(images, points, point_valid=None):
        time.sleep(batch_ms / 1e3)
        return torch.zeros((images.shape[0], h, w, cfg.num_classes), dtype=cfg.compute_dtype)
    return forward


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    add_output_root_arg(ap)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="engine batch (the bench eval shape)")
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=None,
                    help="batch-size ladder for the main engine; overrides --batch-size")
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 8, 32, 64])
    ap.add_argument("--duration", type=float, default=10.0,
                    help="seconds of closed-loop load per concurrency level")
    ap.add_argument("--frames", type=int, default=64, help="distinct pre-generated frames")
    ap.add_argument("--tiny", action="store_true", help="CPU smoke shapes")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--scatter-impl", default=None, choices=SCATTER_IMPLS)
    ap.add_argument("--checkpoint", default=None,
                    help="serve trained weights instead of seed 0's (throughput is "
                    "weight-independent)")
    ap.add_argument("--baseline-b1", action="store_true",
                    help="also measure a no-batching B=1 engine at C=1")
    ap.add_argument("--soak", type=float, default=None,
                    help="after the concurrency ladder, a steady-state soak of this many "
                    "seconds: p50/p95/p99/p999 and split-half throughput drift")
    ap.add_argument("--soak-concurrency", type=int, default=32)
    ap.add_argument("--saturation", type=float, default=None,
                    help="an OPEN-loop burst of this many seconds (run_saturation): "
                    "occupancy -> 1.0, shed boundary exercised")
    ap.add_argument("--producers", type=int, default=2)
    ap.add_argument("--max-queue", type=int, default=256,
                    help="engine shed boundary (EngineOverloaded above this queue "
                    "depth); 0 = unbounded")
    ap.add_argument("--null-backend-ms", type=float, default=None,
                    help="ALSO saturate a null-backend engine whose forward is a host "
                    "sleep of this many ms a batch (e.g. the card's measured forward at "
                    "--batch-size): the engine's software ceiling apart from the device")
    ap.add_argument("--out", default=None,
                    help="default <output-root>/docs/serving_bench.json")
    return ap


def main(argv=None) -> dict:
    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.serving import ServingEngine
    args = make_parser().parse_args(argv)
    pin_f32_precision()

    rng = np.random.default_rng(7)
    engine, img_hw, n_pts, on_card, scatter, cfg = build_engine(
        args, args.batch_size, batch_sizes=args.batch_sizes)
    device = device_label(args.device)
    frames = make_frame_pool(rng, args.frames, img_hw, n_pts)
    print(f"device={device} B={args.batch_size} window={args.max_delay_ms}ms "
          f"scatter={scatter} img={img_hw}^2 pts={n_pts}", flush=True)
    t0 = time.monotonic()
    engine.warmup()
    print(f"build+warmup {time.monotonic() - t0:.1f}s", flush=True)

    levels = []
    for c in args.concurrency:
        lats, completed, wall, _ = run_load(engine, frames, c, args.duration)
        st = engine.stats()
        row = {"concurrency": c, "completed": completed,
               "throughput_rps": round(completed / wall, 2),
               "latency_ms": percentiles(lats),
               "occupancy_cum": st["occupancy"],
               "batches_by_size_cum": st["batches_by_size"]}
        levels.append(row)
        print(f"C={c:4d}: {row['throughput_rps']:9.1f} req/s   "
              f"p50 {row['latency_ms']['p50']} ms   p99 {row['latency_ms']['p99']} ms",
              flush=True)

    soak = None
    if args.soak:
        # Tail latency only means anything over thousands of requests, and
        # split-half drift catches slow degradation a short level cannot see.
        c = args.soak_concurrency
        print(f"soak: C={c} for {args.soak:.0f}s ...", flush=True)
        lats, completed, wall, times = run_load(engine, frames, c, args.soak)
        half = wall / 2
        first = [lat for lat, t in zip(lats, times) if t < half]
        second = [lat for lat, t in zip(lats, times) if t >= half]
        soak = {"concurrency": c, "duration_s": round(wall, 1), "completed": completed,
                "throughput_rps": round(completed / wall, 2),
                "latency_ms": percentiles(lats),
                "first_half": {"throughput_rps": round(len(first) / half, 2),
                               "latency_ms": percentiles(first)},
                "second_half": {"throughput_rps": round(len(second) / half, 2),
                                "latency_ms": percentiles(second)}}
        print(f"soak: {soak['throughput_rps']} req/s   p50 {soak['latency_ms']['p50']} ms   "
              f"p99 {soak['latency_ms']['p99']} ms   p999 {soak['latency_ms']['p999']} ms   "
              f"halves {soak['first_half']['throughput_rps']} -> "
              f"{soak['second_half']['throughput_rps']} req/s", flush=True)
    saturation = None
    if args.saturation:
        # End-to-end latency here is queue wait by design; the outputs that
        # mean something are occupancy, shed rate, frames/s and drift.
        print(f"saturation: open-loop burst for {args.saturation:.0f}s "
              f"(producers={args.producers}, max_queue={args.max_queue}) ...", flush=True)
        engine.reset_stats()
        lats, completed, sheds, wall, times = run_saturation(
            engine, frames, args.saturation, producers=args.producers,
            max_outstanding=max(args.max_queue * 2, 512))
        st = engine.stats()
        half = wall / 2
        first = [lat for lat, t in zip(lats, times) if t < half]
        second = [lat for lat, t in zip(lats, times) if t >= half]
        saturation = {"duration_s": round(wall, 1), "producers": args.producers,
                      "max_queue": args.max_queue, "completed": completed, "shed": sheds,
                      "shed_frac": round(sheds / max(1, sheds + completed), 4),
                      "throughput_rps": round(completed / wall, 2),
                      "occupancy": st["occupancy"],
                      "batches_by_size": st["batches_by_size"],
                      "engine_batch_latency_ms": st["latency_ms"],
                      "e2e_latency_ms": percentiles(lats),
                      "first_half_rps": round(len(first) / half, 2),
                      "second_half_rps": round(len(second) / half, 2)}
        print(f"saturation: {saturation['throughput_rps']} req/s   occupancy "
              f"{saturation['occupancy']}   shed {saturation['shed_frac']:.1%}   e2e p50 "
              f"{saturation['e2e_latency_ms']['p50']} ms", flush=True)
    engine.close()

    null = None
    if args.null_backend_ms is not None:
        # The same saturation drive against an engine whose "device" is a
        # host sleep a batch: can the engine's machinery (dispatcher,
        # completer, per-request preprocessing, futures) sustain the card's
        # frames/s if the device took exactly that long?
        neng = ServingEngine(null_backend(cfg, args.null_backend_ms),
                             batch_size=args.batch_size, image_size=(img_hw, img_hw),
                             num_points=n_pts, max_delay_ms=args.max_delay_ms,
                             max_queue=args.max_queue)
        dur = args.saturation or 10.0
        lats, completed, sheds, wall, _ = run_saturation(
            neng, frames, dur, producers=args.producers,
            max_outstanding=max(args.max_queue * 2, 512))
        st = neng.stats()
        neng.close()
        null = {"batch_ms": args.null_backend_ms, "duration_s": round(wall, 1),
                "completed": completed, "shed": sheds,
                "throughput_rps": round(completed / wall, 2),
                "occupancy": st["occupancy"],
                "engine_batch_latency_ms": st["latency_ms"],
                "e2e_latency_ms": percentiles(lats)}
        print(f"null-backend ({args.null_backend_ms} ms/batch): {null['throughput_rps']} "
              f"req/s   occupancy {null['occupancy']}", flush=True)

    baseline = None
    if args.baseline_b1:
        eng1, *_ = build_engine(args, 1)
        eng1.warmup()
        lats, completed, wall, _ = run_load(eng1, frames, 1, args.duration)
        eng1.close()
        baseline = {"throughput_rps": round(completed / wall, 2),
                    "latency_ms": percentiles(lats)}
        print(f"B=1 baseline: {baseline['throughput_rps']} req/s   "
              f"p50 {baseline['latency_ms']['p50']} ms", flush=True)

    best = max(levels, key=lambda r: r["throughput_rps"])
    result = {
        "metric": "serving_throughput_rps",
        "value": best["throughput_rps"],
        "unit": "req/s",
        "device": device,
        "detail": {"batch_size": args.batch_size,
                   "batch_sizes": args.batch_sizes,
                   "max_delay_ms": args.max_delay_ms,
                   "scatter_impl": scatter,
                   "dtype": str(cfg.compute_dtype).replace("torch.", ""),
                   "backend": "cuda" if on_card else "cpu",
                   "tiny": args.tiny,
                   "levels": levels, "soak": soak,
                   "saturation": saturation,
                   "null_backend": null,
                   "baseline_b1": baseline},
    }
    line = json.dumps(result)
    print(line)
    out = args.out or os.path.join(args.output_root, "docs", "serving_bench.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
