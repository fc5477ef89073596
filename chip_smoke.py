#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py                 # everything (needs one GPU)
    python3 chip_smoke.py --phases kernels

Phases:
  1. build   every hand-written kernel (one nvcc per source, in parallel),
             printing the build seconds and what ptxas reports.
  2. kernels each kernel against its plain PyTorch version at the main
             path's shapes (B=8), f32 and bf16, timed with CUDA events
             beside the plain version, the one-call PyTorch equivalent where
             there is one, and the card's bound for the same work.
  3. serving the weighted-fusion student at full width with the three
             kernel opt-ins, seeded random weights and randomised BN
             statistics, behind ServingEngine (batch 8) with 8 client
             threads and one HTTP request; f32 then bf16. Checks: responses
             match direct Predictor calls, f32 logits match the same weights
             on the plain path (unsorted scatter, unfused gate and blocks),
             and every kernel was launched while the engine served.

Output: the card's name and power limit (nvidia-smi), then per-phase lines,
then one `{"kernels": [...]}` JSON line, the nvidia-smi line again, and as
the last line `{"ok": true, "device": {...}}`. Any failed check raises and
the script exits non-zero; without a GPU it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS = {torch.float32: 67e12,  # f32 on CUDA cores (no TF32)
            torch.bfloat16: 989e12}  # bf16 tensor cores, dense
B, IMG, NPTS, GRID = 8, 256, 5000, 64
CLIENTS = 8  # client threads: one full batch in flight
IR_STAGES = [  # (H, Cin, Cout, stride, expansion): the student's 5 stages at 256^2
    (128, 32, 32, 1, 1), (128, 32, 64, 2, 6), (64, 64, 64, 1, 6),
    (64, 64, 128, 2, 6), (32, 128, 128, 1, 6)]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def _event_ms(run, reps: int, per: int) -> float:
    samples = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        samples.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) / per for s, e in samples]))


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph and
    replayed `reps` times, median of the CUDA-event samples. The graph
    removes the host's launch gaps, which at these sizes are longer than
    most of the kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps, inner)


def eager_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Time of one eager call, host launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _event_ms(run, reps, inner)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, dtype) -> float:
    """f32: |got - want| <= 1e-4 (summation order differs); bf16: the error
    over max(1, max|want|) <= 2e-2 (one bf16 rounding of an intermediate
    may land on the other side). Returns the max absolute error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = err <= 1e-4 if dtype == torch.float32 else err <= 2e-2 * scale
    if not (ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} [{dtype}]: max abs err {err:g} (scale {scale:g})")
    return err


# -- kernel phase ------------------------------------------------------------


def make_points(rng, n=NPTS, batch=B):
    pts = rng.normal(0, 30, (batch, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-5, 3, (batch, n))
    pts[..., 3] = rng.uniform(0, 1, (batch, n))
    # Points exactly on cell boundaries and on the range edges: the host sort
    # key and the device index must agree on them too.
    k = rng.integers(0, GRID, (batch, 300))
    pts[:, :300, 0] = (np.float32(-50.0) + k.astype(np.float32)
                       * np.float32(100.0 / (GRID - 1))).astype(np.float32)
    pts[:, 300:310, 1] = 50.0
    pts[:, 310:320, 1] = -50.0
    return pts


def sorted_inputs(rng, C, dtype, dev):
    """Cell-sorted points, their keys on the device (checked against the
    host sort key) and features with ties and all-negative rows."""
    from lmsu_tpu_torch.data.rasterize import bev_cell_key
    from lmsu_tpu_torch.ops.scatter import points_to_bev_indices
    from lmsu_tpu_torch.ops.scatter_sorted import cell_keys
    rng_range = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    pts = make_points(rng)
    pv = np.ones((B, NPTS), bool)
    pv[:, -400:] = False
    host_key = bev_cell_key(pts, (GRID, GRID), rng_range, pv)
    order = np.argsort(host_key, axis=1, kind="stable")
    pts = np.take_along_axis(pts, order[..., None], 1)
    pv = np.take_along_axis(pv, order, 1)
    host_key = np.take_along_axis(host_key, order, 1)
    pts_d = torch.from_numpy(pts).to(dev)
    flat_idx, valid = points_to_bev_indices(pts_d[..., :2], (GRID, GRID), rng_range)
    keys = cell_keys(flat_idx, valid & torch.from_numpy(pv).to(dev), GRID * GRID)
    if not np.array_equal(keys.cpu().numpy(), host_key):
        bad = int((keys.cpu().numpy() != host_key).sum())
        raise AssertionError(f"device cell index != host sort key at {bad} points")
    f = rng.normal(0, 1, (B, NPTS, C)).astype(np.float32)
    f = np.round(f * 4) / 4          # coarse values: many ties inside a cell
    f[1] = -np.abs(f[1]) - 0.25      # one cloud of all-negative features
    feats = torch.from_numpy(f).to(dev, dtype)
    return feats, keys


def kernel_scatter(rng, dev, dtype, C):
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    hw = GRID * GRID
    feats, keys = sorted_inputs(rng, C, dtype, dev)
    got = ss.segment_max(feats, keys, hw)
    want = ss.segment_max_plain(feats, keys, hw)
    # The one PyTorch call computing the same function (timed, never used).
    idx = torch.where(keys < hw, keys.long() + torch.arange(B, device=dev)[:, None] * hw,
                      B * hw).reshape(-1, 1).expand(-1, C)
    src = feats.reshape(-1, C)
    lib_out = torch.zeros(B * hw + 1, C, dtype=dtype, device=dev)

    def library():
        lib_out.scatter_reduce_(0, idx, src, "amax", include_self=False)

    library()
    torch.cuda.synchronize()
    lib = lib_out[:-1].reshape(B, hw, C)
    if not (torch.equal(got, want) and torch.equal(got, lib)):
        raise AssertionError(f"scatter_sorted_fwd C={C} {dtype}: not bit-exact "
                             f"({(got.float() - want.float()).abs().max().item():g})")
    k_np = keys.cpu().numpy()
    n_empty = B * hw - sum(len(np.unique(r[r < hw])) for r in k_np)
    # The work this data needs: the rows of valid points (invalid ones sort
    # past every cell's span and are never read), the keys, the output.
    n_valid = int((k_np < hw).sum())
    es = feats.element_size()
    nbytes = n_valid * C * es + keys.numel() * 4 + B * hw * C * es
    bound, by = bound_ms(nbytes, n_valid * C, dtype)
    return {"ms": time_ms(lambda: ss.segment_max(feats, keys, hw)),
            "eager_ms": eager_ms(lambda: ss.segment_max(feats, keys, hw)),
            "plain_ms": time_ms(lambda: ss.segment_max_plain(feats, keys, hw), reps=20, inner=2),
            "library_ms": time_ms(library), "bound_ms": bound, "bound_by": by,
            "max_abs_err": 0.0, "shape": f"feats [{B},{NPTS},{C}], out [{B},{GRID},{GRID},{C}]",
            "empty_cells": int(n_empty)}


def kernel_gate(rng, dev, dtype, C=128):
    from lmsu_tpu_torch.ops import fusion_gate as fg
    M = B * GRID * GRID
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    cam = t(rng.normal(0, 1, (B, GRID, GRID, C))).to(dtype)
    lid = t(rng.normal(0, 1, (B, GRID, GRID, C))).to(dtype)
    w1 = t(rng.normal(0, 0.08, (C, 2 * C, 1, 1)))
    b1 = t(rng.normal(0, 0.1, (C,)))
    w2 = t(rng.normal(0, 0.1, (2, C, 1, 1)))
    b2 = t(rng.normal(0, 0.1, (2,)))
    args = (cam, lid, w1, b1, w2, b2)
    err = check_close("fusion_gate", fg.fusion_gate(*args), fg.fusion_gate_plain(*args), dtype)
    es = cam.element_size()
    nbytes = 3 * M * C * es + (2 * C * C + 3 * C + 2) * 4
    ops = 2 * M * 2 * C * C + 2 * M * C + 6 * M * C
    bound, by = bound_ms(nbytes, ops, dtype)
    return {"ms": time_ms(lambda: fg.fusion_gate(*args)),
            "eager_ms": eager_ms(lambda: fg.fusion_gate(*args)),
            "plain_ms": time_ms(lambda: fg.fusion_gate_plain(*args)),
            "library_ms": None, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "shape": f"cam/lid [{B},{GRID},{GRID},{C}], w1 [{C},{2 * C}]"}


def random_ir_params(rng, dev, Cin, Cout, exp):
    from lmsu_tpu_torch.ops.ir_fused import IRParams
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    Ce = Cin * exp
    sb = lambda c: (t(rng.uniform(0.5, 1.5, c)), t(rng.normal(0, 0.2, c)))  # noqa: E731
    s1, b1 = sb(Ce)
    s2, b2 = sb(Ce)
    s3, b3 = sb(Cout)
    w1 = t(rng.normal(0, np.sqrt(2.0 / Cin), (Cin, Ce))) if exp != 1 else None
    return IRParams(w1, s1 if w1 is not None else None, b1 if w1 is not None else None,
                    t(rng.normal(0, np.sqrt(2.0 / 9), (3, 3, Ce))), s2, b2,
                    t(rng.normal(0, np.sqrt(2.0 / Ce), (Ce, Cout))), s3, b3)


def kernel_ir(rng, dev, dtype):
    from lmsu_tpu_torch.ops import ir_fused as irf
    total = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    stages = []
    for H, Cin, Cout, stride, exp in IR_STAGES:
        x = torch.from_numpy(rng.uniform(0, 3, (B, H, H, Cin)).astype(np.float32)).to(dev, dtype)
        p = random_ir_params(rng, dev, Cin, Cout, exp)
        err = check_close(f"ir_fused_infer stage {H}x{Cin}->{Cout}/s{stride}",
                          irf.fused_ir_infer(x, p, stride), irf.fused_ir_infer_plain(x, p, stride),
                          dtype)
        Ce, Ho = Cin * exp, H // stride
        es = x.element_size()
        wbytes = ((Cin * Ce if exp != 1 else 0) + Ce * Cout) * es + (9 * Ce + 4 * Ce + 2 * Cout) * 4
        nbytes = B * H * H * Cin * es + B * Ho * Ho * Cout * es + wbytes
        ops = 2 * B * (H * H * Cin * Ce * (exp != 1) + 9 * Ho * Ho * Ce + Ho * Ho * Ce * Cout)
        bound, by = bound_ms(nbytes, ops, dtype)
        st = {"stage": f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}",
              "ms": time_ms(lambda: irf.fused_ir_infer(x, p, stride)),
              "eager_ms": eager_ms(lambda: irf.fused_ir_infer(x, p, stride)),
              "plain_ms": time_ms(lambda: irf.fused_ir_infer_plain(x, p, stride)),
              "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        stages.append(st)
        for k in ("ms", "eager_ms", "plain_ms", "bound_ms"):
            total[k] += st[k]
        total["max_abs_err"] = max(total["max_abs_err"], err)
    ops_by = {s["bound_by"] for s in stages}
    total.update({"library_ms": None,
                  "bound_by": "operations" if "operations" in ops_by else "bytes",
                  "stages": stages, "shape": "the 5 camera stages at B=8, 256^2 input"})
    return total


def phase_kernels(dev):
    rng = np.random.default_rng(0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for C in (128, 256):
            r = kernel_scatter(rng, dev, dtype, C)
            res[("scatter", name, C)] = r
            log(f"[kernels] scatter_sorted_fwd {name} C={C}: bit-exact; "
                f"{json.dumps(r)}")
        res[("gate", name)] = kernel_gate(rng, dev, dtype)
        log(f"[kernels] fusion_gate {name}: {json.dumps(res[('gate', name)])}")
        res[("ir", name)] = kernel_ir(rng, dev, dtype)
        log(f"[kernels] ir_fused_infer {name}: {json.dumps(res[('ir', name)])}")
    return res


# -- serving phase -----------------------------------------------------------


def serving_config(dtype, kernels=True):
    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    return ModelConfig(
        num_classes=2, fusion_type="weighted", fusion_out_channels=128,
        use_pallas_fusion=kernels,
        camera=CameraEncoderConfig(fused_inference=kernels),
        lidar=LidarEncoderConfig(scatter_impl="sorted_pallas" if kernels else "xla"),
        compute_dtype=dtype)


def randomize_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)


def make_frames(rng, n):
    frames = []
    for _ in range(n):
        npts = int(rng.integers(4000, 6001))  # both padding and subsampling occur
        img = rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
        pts = make_points(rng, npts, 1)[0]
        frames.append((img, pts))
    return frames


def profile_forward(pred, frames, prepped, reps: int = 5):
    """Where one B=8 forward's time goes: host wall time to a synchronised
    result, device time from torch.profiler (the sum over device-side
    events: kernels and copies), and the kernels with the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    imgs = np.stack([f[0] for f in frames])
    pts = np.stack([p for p, _ in prepped])
    pv = np.stack([v for _, v in prepped])
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward_batch(imgs, pts, pv)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pred.forward_batch(imgs, pts, pv)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"wall_ms_median": float(np.median(walls)), "device_ms": device_ms,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:12]]}


def phase_serving(dev, dtype, state_dict=None):
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.serving import ServingEngine, make_server
    name = "f32" if dtype == torch.float32 else "bf16"
    pred = Predictor(serving_config(dtype), state_dict, device=dev, seed=0)
    if state_dict is None:
        randomize_bn(pred.model, 1)
    engine = ServingEngine.from_predictor(pred, batch_size=B, image_size=(IMG, IMG),
                                          num_points=NPTS, max_delay_ms=5.0)
    server = None
    try:
        t0 = time.perf_counter()
        engine.warmup()
        log(f"[serving {name}] warmup {time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(7)
        frames = make_frames(rng, 32)
        results = [None] * len(frames)

        def client(k):  # closed loop: submit one frame, wait for it, repeat
            for i in range(k, len(frames), CLIENTS):
                results[i] = engine.submit(*frames[i]).result(timeout=300)

        reset_launch_counts()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            raise AssertionError("serving clients did not finish")
        stats = engine.stats()
        server = make_server(engine, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        buf = io.BytesIO()
        np.savez(buf, image=frames[0][0], points=frames[0][1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/predict",
            data=buf.getvalue(), headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=120) as r:
            http_logits = np.load(io.BytesIO(r.read()))["logits"]
        launches = {k: v.launches for k, v in kernels().items()}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched while serving: {launches}")

        # (a) every response equals the Predictor called directly on the
        # same preprocessed frames, batched by 8.
        prepped = [engine._prep_points(pts, None) for _, pts in frames]
        direct = []
        for s in range(0, len(frames), B):
            idx = list(range(s, min(s + B, len(frames))))
            imgs = np.stack([frames[i][0] for i in idx])
            pts = np.stack([prepped[i][0] for i in idx])
            pv = np.stack([prepped[i][1] for i in idx])
            out = pred.forward_batch(imgs, pts, pv).float().cpu().numpy()
            direct.extend(out)
        tol_a = 1e-5 if dtype == torch.float32 else 2e-2
        err_a = max(float(np.abs(results[i] - direct[i]).max()) for i in range(len(frames)))
        err_http = float(np.abs(http_logits - direct[0]).max())
        for r in results + [http_logits]:
            if r.shape != (GRID, GRID, 2) or not np.isfinite(r).all():
                raise AssertionError(f"bad response: shape {r.shape}")
        if max(err_a, err_http) > tol_a:
            raise AssertionError(f"engine != direct Predictor: {err_a:g} / http {err_http:g}")
        out = {"stats": stats, "launches": launches, "err_engine_vs_direct": err_a,
               "err_http_vs_direct": err_http}

        # (b) f32: the same weights on the plain path (unsorted scatter,
        # unfused gate and blocks) give the same logits.
        if dtype == torch.float32:
            plain = Predictor(serving_config(dtype, kernels=False), pred.model.state_dict(),
                              device=dev)
            err_b = 0.0
            for s in range(0, len(frames), B):
                idx = list(range(s, min(s + B, len(frames))))
                imgs = np.stack([frames[i][0] for i in idx])
                pts = np.stack([prepped[i][0] for i in idx])
                pv = np.stack([prepped[i][1] for i in idx])
                perm = rng.permutation(NPTS)  # the plain scatter takes any order
                a = pred.forward_batch(imgs, pts, pv).float().cpu().numpy()
                b = plain.forward_batch(imgs, pts[:, perm], pv[:, perm]).float().cpu().numpy()
                err_b = max(err_b, float(np.abs(a - b).max()))
            if err_b > 1e-3:
                raise AssertionError(f"kernel path != plain path: {err_b:g}")
            out["err_kernels_vs_plain_path"] = err_b
        out["forward"] = profile_forward(pred, frames[:B], prepped[:B])
        log(f"[serving {name}] {json.dumps(out)}")
        return out, pred.model.state_dict()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.close()


# -- main --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="kernels,serving",
                    help="comma list of kernels,serving (build always runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lmsu_tpu_torch.ops._cuda import build_all, kernels

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    secs = build_all()
    log(f"[build] {len(kernels())} kernels in {secs:.2f} s")
    for k in kernels().values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {k.name}: {line.strip()}")

    phases = set(args.phases.split(","))
    kres = phase_kernels(dev) if "kernels" in phases else {}
    sres = {}
    if "serving" in phases:
        sres["f32"], sd = phase_serving(dev, torch.float32)
        sres["bf16"], _ = phase_serving(dev, torch.bfloat16, sd)

    meta = {
        "scatter_sorted_fwd": ("lmsu_tpu/ops/scatter_sorted_pallas.py:163", ("scatter", 128)),
        "fusion_gate": ("lmsu_tpu/ops/fusion_pallas.py:41", ("gate",)),
        "ir_fused_infer": ("lmsu_tpu/ops/ir_fused.py:223", ("ir",)),
    }
    lines = []
    for name, (replaces, key) in meta.items():
        entry = {"name": name, "route": "cuda", "source": f"lmsu_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces,
                 "launches": sres.get("f32", {}).get("launches", {}).get(name, 0)}
        if kres:
            f32 = kres[(key[0], "f32") + key[1:]]
            bf16 = dict(kres[(key[0], "bf16") + key[1:]])
            bf16["launches"] = sres.get("bf16", {}).get("launches", {}).get(name, 0)
            entry.update({k: f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "eager_ms",
                                              "shape")})
            entry["kernel_ms"] = f32["ms"]
            if "stages" in f32:
                entry["stages"] = f32["stages"]
            if key[0] == "scatter":
                entry["c256"] = {"f32": kres[("scatter", "f32", 256)],
                                 "bf16": kres[("scatter", "bf16", 256)]}
            entry["dtype"] = "float32"
            entry["bf16"] = bf16
        lines.append(entry)
    print(json.dumps({"kernels": lines}))
    if sres:
        print(json.dumps({"serving": {k: v["stats"] for k, v in sres.items()},
                          "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
