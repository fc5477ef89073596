#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py                 # everything (needs one GPU)
    python3 chip_smoke.py --phases kernels,train

Phases:
  1. build   every hand-written kernel (one nvcc per source, in parallel),
             printing the build seconds and what ptxas reports.
  2. kernels each kernel against its plain PyTorch version at the main
             paths' shapes, f32 and bf16: serving at B=8, the KD step at
             B=128 with the student's C=128 and the teacher's C=256 (K1, K2,
             K4, K6), the fused training kernels K8-K13 at each of the
             student's five InvertedResidual stages at B=128; timed with
             CUDA events beside the plain version, the PyTorch equivalent
             where there is one, and the card's bound; each stage's fused
             forward + backward beside the unfused block's (cuDNN convs,
             train-mode BN), with K12's shared memory and resident blocks
             per SM at each stage; K9 and K12 must compute e = x . W1 bit
             for bit alike (each kernel's probe build writes its e; the
             count of differing elements is printed and must be 0), K8's
             probe e is compared with K9's the same way (the count is
             printed; K8 itself is held by its sums), and
             in f32 K13's dW1 and K11's dW2 must be within 1e-4 of scale
             of a float64 dW1 / dW2 computed on the card; K10's and K11's
             shared memory and resident blocks per SM are printed too; K11
             also on ties (v2 exactly 0 and 6: dv2's zeros must be the
             plain version's) and, beside K10, with Cout 1000 in chunks. K7
             also on a near-teacher student (S = T.P + 1e-3 N(0, 1)); K2
             also at C=512 (a 4x teacher; whether it is no slower than its
             plain version is printed), with each shape's tile rows, shared
             memory and resident blocks, and at six other widths at B=2
             (padded K, rows that are not 16-byte multiples, x streamed past
             a 32-row tile). The scatter kernels K4, K5 and K6 (and
             K1 beside K4) also on a skewed cloud: 2,000 of the 5,000 points
             in one cell, as zero padding puts them. K1, K4 and K5 print
             their plan (vector bytes, walkers, rows a step or a window,
             shared memory, blocks per SM, blocks) at each shape and are
             also checked at B=2 on edge clouds (check_sorted_scatter_edges):
             C = 40, 42, 136 and 2, N = 4,999, an all-invalid image, a 100 x
             100 grid, cells of each walk's long-span threshold - 1, + 0 and
             + 1 rows and of 2,000 rows, and for K4 (with each of its two
             stage sizes) cells of 255, 256, 257 and 2,000 points placed at
             its window edges; K1 and K4 bit for bit, K5 exactly. The NaN
             contract (check_nan_scatter, check_nan_dense): on clouds with
             NaN of both signs K1, K4 and K6 give NaN exactly where their
             plain versions (run on the CPU) do and equal them bit for bit
             elsewhere, K5 equals its plain version exactly; on inputs with
             a few NaN K2, K3 and the five fused training blocks (K8-K13)
             keep NaN where their plain versions do. K6 is also held bit for
             bit to an integer-keyed reference (signs of zero too) and, at
             B=2, on edge clouds: +-0.0 features, an all-invalid image, N =
             4,999, C = 40 and 136, a 100 x 100 grid; its launch plan (slice,
             shared memory, blocks per SM) is printed for each. K3 prints its
             plan (tile, shared memory, blocks per SM) per stage and is also
             checked at widths that are multiples of 4 but not of 16, at the
             2x teacher's five stages, and in bf16 on a block where rounding
             e before BN1 would change the output (bit for bit).
  3. serving the weighted-fusion student at full width with the three
             kernel opt-ins, seeded random weights and randomised BN
             statistics, behind ServingEngine (batch 8) with 8 client
             threads and one HTTP request; f32 then bf16. Checks: responses
             match direct Predictor calls, f32 logits match the same weights
             on the plain path (unsorted scatter, unfused gate and blocks),
             and every kernel was launched while the engine served. Then
             two f32 runs of 16 frames with the other scatter kernels: the
             unsorted scatter (scatter_impl="pallas", K6; no host sort) and
             the flat sorted forward (`_FWD_FLAT`, K4), each without K1.
  4. train   the KD step of bench.py (weighted/128 student, 2x teacher,
             seeded weights) through DistillationTrainer.train_step at
             B=128 on one fixed cell-sorted batch, f32 then bf16, with the
             in-loop teacher and then the cached teacher: 3 warm-up and 10
             timed steps each, launches per step, device time by kernel
             (torch.profiler). Checks: at B=8 in f32 one step's loss,
             gradients and BN running statistics on the kernel path match
             the plain path; the loss falls over the timed steps; K1, K2,
             K5 and K7 were launched. Then one epoch of `python -m
             lmsu_tpu_torch.train_distill` on synthetic data writes its
             history and checkpoints. Then the fused training path
             (CameraEncoderConfig.fused_train): one B=8 f32 step against
             the same step with K8-K13's plain versions and against the
             unfused step (loss, gradients, BN running statistics; the
             gate's ReLU-mask entries that differ between the steps are
             counted and their part of its W1 gradient taken out), and the
             in-loop step at B=128 in f32 and bf16 (loss must fall, K8-K13
             must launch). Then scatter_impl="pallas": one B=8 f32 step on
             the kernel path against the plain path, and the in-loop step at
             B=128 in f32 and bf16 on points in their own order (loss must
             fall, K6 twice per step, K1 and K5 never).

Output: the card's name and power limit (nvidia-smi), then per-phase lines,
then one `{"kernels": [...]}` JSON line, the serving and train summaries,
the nvidia-smi line again, and as the last line `{"ok": true, "device":
{...}}`. Any failed check raises and the script exits non-zero; without a
GPU it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
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
TRAIN_B = 128  # bench.py's HEADLINE_BATCH
CLIENTS = 8  # client threads: one full batch in flight
SERVING_KERNELS = ("scatter_sorted_fwd", "fusion_gate", "ir_fused_infer")
SCATTER_KERNELS = ("scatter_sorted_fwd", "scatter_sorted_fwd_flat", "voxelize_scatter_max")
SKEW = 2000  # points of each skewed cloud in the centre cell
TRAIN_KERNELS = ("scatter_sorted_fwd", "fusion_gate", "scatter_sorted_bwd", "kd_feature_mse")
IR_TRAIN_KERNELS = ("ir_train_stats1", "ir_train_expand_dw", "ir_train_proj",
                    "ir_train_proj_bwd", "ir_train_dw_bwd", "ir_train_expand_bwd")
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


def check_close(name, got, want, dtype, scaled: bool = False) -> float:
    """f32: |got - want| <= 1e-4 (summation order differs), times
    max(1, max|want|) when `scaled` (K8-K13: GEMM depths up to 768, sums over
    up to 2M pixels); bf16: the error over max(1, max|want|) <= 2e-2 (one
    bf16 rounding of an intermediate may land on the other side). Returns
    the max absolute error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = (scale if scaled else 1.0) * 1e-4 if dtype == torch.float32 else 2e-2 * scale
    ok = err <= tol
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


def sorted_inputs(rng, C, dtype, dev, batch=B, skew=False):
    """Cell-sorted points, their keys on the device (checked against the
    host sort key) and features with ties and all-negative rows. The
    uniform cloud has 400 invalid points; the skewed one has its last SKEW
    points zero-padded and valid, all in the centre cell (31, 31), as a
    frame padded without point_valid gives them."""
    from lmsu_tpu_torch.data.rasterize import bev_cell_key
    from lmsu_tpu_torch.ops.scatter import points_to_bev_indices
    from lmsu_tpu_torch.ops.scatter_sorted import cell_keys
    rng_range = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    pts = make_points(rng, batch=batch)
    pv = np.ones((batch, NPTS), bool)
    if skew:
        pts[:, -SKEW:] = 0.0
    else:
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
    f = rng.normal(0, 1, (batch, NPTS, C)).astype(np.float32)
    f = np.round(f * 4) / 4          # coarse values: many ties inside a cell
    f[1] = -np.abs(f[1]) - 0.25      # one cloud of all-negative features
    feats = torch.from_numpy(f).to(dev, dtype)
    return feats, keys


def scatter_library(feats, keys, hw):
    """The one PyTorch call computing the scatter kernels' function,
    scatter_reduce_ amax into a zero buffer with include_self=False, and its
    result [B, hw, C] (timed as a yardstick, never used by the port)."""
    Bn, _, C = feats.shape
    idx = torch.where(keys < hw, keys.long() + torch.arange(Bn, device=feats.device)[:, None] * hw,
                      Bn * hw).reshape(-1, 1).expand(-1, C)
    src = feats.reshape(-1, C)
    out = torch.zeros(Bn * hw + 1, C, dtype=feats.dtype, device=feats.device)

    def library():
        out.scatter_reduce_(0, idx, src, "amax", include_self=False)

    library()
    torch.cuda.synchronize()
    return library, out[:-1].reshape(Bn, hw, C)


def scatter_bound(feats, keys, hw):
    """K1/K4/K6's bound: the rows of valid points (invalid ones are never
    read), the keys, the output; one compare per valid element."""
    Bn, _, C = feats.shape
    n_valid = int((keys < hw).sum().item())
    es = feats.element_size()
    return bound_ms(n_valid * C * es + keys.numel() * 4 + Bn * hw * C * es, n_valid * C,
                    feats.dtype)


def kernel_scatter(rng, dev, dtype, C, B=B):
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    hw = GRID * GRID
    feats, keys = sorted_inputs(rng, C, dtype, dev, B)
    got = ss.segment_max(feats, keys, hw)
    want = ss.segment_max_plain(feats, keys, hw)
    library, lib = scatter_library(feats, keys, hw)
    if not (torch.equal(got, want) and torch.equal(got, lib)):
        raise AssertionError(f"scatter_sorted_fwd C={C} {dtype}: not bit-exact "
                             f"({(got.float() - want.float()).abs().max().item():g})")
    k_np = keys.cpu().numpy()
    n_empty = B * hw - sum(len(np.unique(r[r < hw])) for r in k_np)
    bound, by = scatter_bound(feats, keys, hw)
    plan = ss.segment_max_plan(B, NPTS, C, hw, dtype) if dev.type == "cuda" else None
    return {"plan": plan, "ms": time_ms(lambda: ss.segment_max(feats, keys, hw)),
            "eager_ms": eager_ms(lambda: ss.segment_max(feats, keys, hw)),
            "plain_ms": time_ms(lambda: ss.segment_max_plain(feats, keys, hw), reps=20, inner=2),
            "library_ms": time_ms(library), "bound_ms": bound, "bound_by": by,
            "max_abs_err": 0.0, "shape": f"feats [{B},{NPTS},{C}], out [{B},{GRID},{GRID},{C}]",
            "empty_cells": int(n_empty)}


def keyed_scatter_max(feats, keys, hw):
    """An exact reference for K6 independent of float atomics: each feature
    as its order-preserving integer key (x >= 0: bits | 2^31; x < 0: ~bits),
    an int64 scatter_reduce_ amax from 0 (untouched), and back. Integers take
    no rounding and their max no order, so this gives -0.0 below +0.0 bit
    for bit, where the float amax of the plain version returns whichever
    zero its atomics met first (torch.equal takes -0.0 == +0.0); a cell
    holding a NaN is NaN."""
    Bn, N, C = feats.shape
    bits = feats.float().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(bits >= 2 ** 31, ~bits & 0xFFFFFFFF, bits | 2 ** 31)
    # A NaN of either sign takes the largest key: it wins, as the max of the
    # JAX package's xla route keeps it (written back as the NaN 0x7fffffff).
    key = torch.where(torch.isnan(feats.float()), 0xFFFFFFFF, key)
    idx = torch.where((keys >= 0) & (keys < hw), keys, hw).long()
    acc = torch.zeros(Bn, hw + 1, C, dtype=torch.int64, device=feats.device)
    acc.scatter_reduce_(1, idx.unsqueeze(-1).expand(Bn, N, C), key, "amax")
    acc = acc[:, :hw]
    out = torch.where(acc >= 2 ** 31, acc & 0x7FFFFFFF, ~acc & 0xFFFFFFFF)
    out = torch.where(acc == 0, 0, out)
    out = out - (out >= 2 ** 31).long() * 2 ** 32
    return out.to(torch.int32).view(torch.float32).to(feats.dtype)


def same_bits(a, b) -> bool:
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def same_bits_nan(a, b) -> bool:
    """NaN at the same places (any NaN equals any NaN: the kernels write the
    canonical one, the plain versions the one they met), every other
    element bit for bit."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and same_bits(a.masked_fill(na, 0), b.masked_fill(nb, 0)))


def check_close_nan(name, got, want, dtype, scaled: bool = False, some: bool = True) -> float:
    """NaN at exactly the plain version's places (which must hold some, with
    `some`), the other elements within check_close's limits."""
    ng, nw = torch.isnan(got), torch.isnan(want)
    if some and not nw.any():
        raise AssertionError(f"{name} [{dtype}]: the inputs' NaN reached no output")
    if not torch.equal(ng, nw):
        raise AssertionError(f"{name} [{dtype}]: NaN at {int(ng.sum())} places, the plain "
                             f"version at {int(nw.sum())} ({int((ng != nw).sum())} differ)")
    return check_close(name, got.masked_fill(ng, 0), want.masked_fill(nw, 0), dtype, scaled)


def check_unsorted(what, feats, keys, hw):
    """K6 == its plain version and scatter_reduce_ (values), and == the
    keyed reference bit for bit (signs of zeros too)."""
    from lmsu_tpu_torch.ops import voxelize as vx
    got = vx.scatter_max(feats, keys, hw)
    want = vx.scatter_max_plain(feats, keys, hw)
    library, lib = scatter_library(feats, keys, hw)
    if not (torch.equal(got, want) and torch.equal(got, lib)
            and same_bits(got, keyed_scatter_max(feats, keys, hw))):
        raise AssertionError(f"voxelize_scatter_max {what} {feats.dtype}: not bit-exact "
                             f"({(got.float() - want.float()).abs().max().item():g})")
    return library


def kernel_unsorted(rng, dev, dtype, C, B=B, skew=False):
    """K6 on points in no order (one permutation of the sorted cloud)
    against its plain version and scatter_reduce_, bit for bit, with its
    launch plan."""
    from lmsu_tpu_torch.ops import voxelize as vx
    hw = GRID * GRID
    feats, keys = sorted_inputs(rng, C, dtype, dev, B, skew)
    perm = torch.from_numpy(rng.permutation(NPTS)).to(dev)
    feats, keys = feats[:, perm].contiguous(), keys[:, perm].contiguous()
    library = check_unsorted(f"C={C} B={B} skew={skew}", feats, keys, hw)
    bound, by = scatter_bound(feats, keys, hw)
    run = lambda: vx.scatter_max(feats, keys, hw)  # noqa: E731
    plan = vx.scatter_max_plan(B, NPTS, C, hw, dtype) if dev.type == "cuda" else None
    return {"ms": time_ms(run), "eager_ms": eager_ms(run), "plan": plan,
            "plain_ms": time_ms(lambda: vx.scatter_max_plain(feats, keys, hw), reps=10, inner=2),
            "library_ms": time_ms(library), "library": "scatter_reduce_ amax",
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "shape": f"feats [{B},{NPTS},{C}] unsorted, out [{B},{GRID},{GRID},{C}]"
                     + (f", {SKEW} points in one cell" if skew else "")}


def check_voxelize_edges(rng, dev, dtype, B=2) -> dict:
    """K6 off the main path's shapes, each cloud bit for bit (check_unsorted):
    features of mixed sign with many +-0.0 (cells whose max is -0.0, cells
    with both zeros), an all-invalid image, N = 4,999 (no multiple of a
    batch), C = 40 and 136 (no multiple of the slice), and a 100 x 100 grid
    (10,000 cells: the slice narrows). Returns each cloud's launch plan."""
    from lmsu_tpu_torch.ops import voxelize as vx
    out = {}
    for what, n, C, hw in (("signed zeros", NPTS, 128, GRID * GRID),
                           ("all-invalid image", NPTS, 128, GRID * GRID),
                           ("N=4999", 4999, 128, GRID * GRID), ("C=40", NPTS, 40, GRID * GRID),
                           ("C=136", NPTS, 136, GRID * GRID), ("HW=100x100", NPTS, 128, 10000)):
        keys = rng.integers(0, hw + 1, (B, n))  # hw: an invalid point
        f = np.round(rng.normal(0, 1, (B, n, C)) * 4) / 4
        if what == "signed zeros":
            f = rng.choice(np.array([-1.0, -0.5, -0.0, 0.0, 0.5]), (B, n, C))
            low = keys < 300  # cells whose points are -1 or -0.0 only: max -0.0
            f[low] = rng.choice(np.array([-1.0, -0.0]), (int(low.sum()), C))
            mid = (keys >= 300) & (keys < 600)  # -0.0 and +0.0 only: max +0.0
            f[mid] = rng.choice(np.array([-0.0, 0.0]), (int(mid.sum()), C))
        if what == "all-invalid image":
            keys[0] = hw
        feats = torch.from_numpy(f.astype(np.float32)).to(dev, dtype)
        keys_d = torch.from_numpy(keys.astype(np.int32)).to(dev)
        check_unsorted(what, feats, keys_d, hw)
        out[what] = (vx.scatter_max_plan(B, n, C, hw, dtype) if dev.type == "cuda"
                     else "checked")
    return out


def flat_plan(B, N, C, hw, dtype) -> dict:
    """K4's plan, held to ops/scatter_sorted.py::flat_geometry."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    pl = ss.segment_max_flat_plan(B, N, C, hw, dtype)
    geo = ss.flat_geometry(C, 4 if dtype == torch.float32 else 2, pl["slot_bytes"])
    if ((pl["vector_bytes"], pl["lanes"], pl["walkers"], pl["window_rows"], pl["chunk_rows"],
         pl["slices"], pl["windows_per_image"])
            != (geo["vec"], geo["lanes"], geo["walkers"], geo["window_rows"], geo["chunk_rows"],
                geo["slices"], -(-N // geo["window_rows"]))):
        raise AssertionError(f"scatter_sorted_fwd_flat: plan {pl} is not {geo}")
    return pl


def kernel_flat(rng, dev, dtype, C, B=B, skew=False):
    """K4 against its plain version, K1 and scatter_reduce_, bit for bit,
    on cell-sorted points, with its plan; K1 timed beside it."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    hw = GRID * GRID
    feats, keys = sorted_inputs(rng, C, dtype, dev, B, skew)
    got = ss.segment_max_flat(feats, keys, hw)
    want = ss.segment_max_flat_plain(feats, keys, hw)
    k1 = ss.segment_max(feats, keys, hw)
    library, lib = scatter_library(feats, keys, hw)
    if not (torch.equal(got, want) and torch.equal(got, k1) and torch.equal(got, lib)):
        raise AssertionError(f"scatter_sorted_fwd_flat C={C} B={B} skew={skew} {dtype}: not "
                             f"bit-exact ({(got.float() - want.float()).abs().max().item():g})")
    bound, by = scatter_bound(feats, keys, hw)
    run = lambda: ss.segment_max_flat(feats, keys, hw)  # noqa: E731
    plan = flat_plan(B, NPTS, C, hw, dtype) if dev.type == "cuda" else None
    return {"plan": plan, "ms": time_ms(run), "eager_ms": eager_ms(run),
            "plain_ms": time_ms(lambda: ss.segment_max_flat_plain(feats, keys, hw),
                                reps=5, inner=1),
            "library_ms": time_ms(library), "library": "scatter_reduce_ amax",
            "k1_ms": time_ms(lambda: ss.segment_max(feats, keys, hw)),
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "shape": f"feats [{B},{NPTS},{C}] cell-sorted, out [{B},{GRID},{GRID},{C}]"
                     + (f", {SKEW} points in one cell" if skew else "")}


def kernel_scatter_bwd(rng, dev, dtype, C=128, B=B, skew=False):
    """K5 against its plain version, exactly, on cell-sorted inputs with
    ties, empty cells, an all-negative cloud and one cell of 400 tied points
    (beyond the 256 a bf16 count could hold exactly); with `skew`, on the
    skewed cloud (SKEW points in the centre cell), with its walk's plan."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    hw = GRID * GRID
    feats, keys = sorted_inputs(rng, C, dtype, dev, B, skew)
    k_np = keys.cpu().numpy()
    lo = 1000
    assert k_np[3, lo + 400] < hw
    keys[3, lo:lo + 400] = int(k_np[3, lo])   # one cell takes 400 points ...
    feats[3, lo:lo + 400] = 5.0                # ... all tied at its max
    out = ss.segment_max(feats, keys, hw)
    g = torch.from_numpy(rng.normal(0, 1, (B, hw, C)).astype(np.float32)).to(dev, dtype)
    got = ss.segment_max_bwd(feats, keys, out, g, hw)
    want = ss.segment_max_bwd_plain(feats, keys, out, g, hw)
    if not torch.equal(got, want):
        raise AssertionError(f"scatter_sorted_bwd {dtype}: not exact "
                             f"({(got.float() - want.float()).abs().max().item():g})")
    # The PyTorch yardstick: autograd's backward of scatter_reduce amax
    # (from a -inf buffer, so the buffer is never among the ties).
    src = feats.reshape(-1, C).detach().clone().requires_grad_(True)
    idx = torch.where(keys < hw, keys.long() + torch.arange(B, device=dev)[:, None] * hw,
                      B * hw).reshape(-1, 1).expand(-1, C)
    lib_out = torch.full((B * hw + 1, C), float("-inf"), dtype=dtype, device=dev).scatter_reduce(
        0, idx, src, "amax", include_self=False)
    g_lib = torch.cat([g.reshape(-1, C), g.new_zeros(1, C)])

    def library():
        return torch.autograd.grad(lib_out, src, g_lib, retain_graph=True)[0]

    lib_err = (library().reshape(got.shape).float() - got.float()).abs().max().item()
    k_np = keys.cpu().numpy()
    n_valid = int((k_np < hw).sum())
    n_cells = sum(len(np.unique(r[r < hw])) for r in k_np)
    es = feats.element_size()
    # Valid rows of feats, the keys, out and g of non-empty cells, all of d.
    nbytes = n_valid * C * es + keys.numel() * 4 + 2 * n_cells * C * es + B * NPTS * C * es
    bound, by = bound_ms(nbytes, 2 * n_valid * C, dtype)
    run = lambda: ss.segment_max_bwd(feats, keys, out, g, hw)  # noqa: E731
    plan = ss.segment_max_bwd_plan(B, NPTS, C, hw, dtype) if dev.type == "cuda" else None
    return {"plan": plan, "ms": time_ms(run), "eager_ms": eager_ms(run),
            "plain_ms": time_ms(lambda: ss.segment_max_bwd_plain(feats, keys, out, g, hw),
                                reps=20, inner=2),
            "library_ms": eager_ms(library), "library": "autograd backward of "
            "scatter_reduce amax (eager: launches included)", "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "shape": f"feats [{B},{NPTS},{C}], out/g [{B},{GRID},{GRID},{C}]"
                     + (f", {SKEW} points in one cell" if skew else ""),
            "max_ties": 400, "empty_cells": int(B * hw - n_cells)}


def check_sorted_scatter_edges(rng, dev, dtype, B=2) -> dict:
    """K1, K4 and K5 off the main path's shapes, at B=2 on cell-sorted
    clouds of their own: K1 and K4 bit for bit against their plain versions
    and scatter_reduce_ (K4 also against K1), K5 exactly against its plain
    version. C = 40, 42, 136 and 2 (rows that are not 16-byte multiples
    take narrower vectors on the same walk), N = 4,999, an all-invalid
    image, a 100 x 100 grid, and at C=128 a cell of exactly each walk's
    long-span threshold (its rows a step, one ring slot), of the threshold
    - 1 and + 1 rows (a span longer than a slot) and of 2,000 rows; and for
    K4 cells of 255, 256, 257 and 2,000 points placed at its windows (in
    image 0 from the first point of a window of the larger stage, in image
    1 from three points before one of the smaller), so that runs start, end
    and cross at window edges and one run spans many windows. K4 runs with
    each of its two stage sizes (flat_stage) on every cloud. Returns each
    kernel's plan for each cloud; K1's and K5's geometry must be
    ops/scatter_sorted.py::walk_geometry's, K4's flat_geometry's."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    es = 2 if dtype == torch.bfloat16 else 4
    hw0 = GRID * GRID
    clouds = [(f"C={C}", NPTS, C, hw0, 0) for C in (40, 42, 136, 2)]
    clouds += [("N=4999", 4999, 128, hw0, 0), ("all-invalid image", NPTS, 128, hw0, 0),
               ("HW=100x100", NPTS, 128, 10000, 0)]
    for kind in ("fwd", "bwd"):
        cap = ss.walk_geometry(128, es, kind)["cap"]
        clouds += [(f"{kind} threshold {span}", NPTS, 128, hw0, span)
                   for span in (cap - 1, cap, cap + 1)]
    clouds.append(("span 2000", NPTS, 128, hw0, 2000))
    clouds += [(f"flat window run {span}", NPTS, 128, hw0, span) for span in (255, 256, 257, 2000)]
    windows = [ss.flat_geometry(128, es, slot)["window_rows"]
               for slot in (ss.FLAT_SLOT_BYTES, ss.FLAT_SLOT_BYTES_SMALL)]
    out = {}
    for what, n, C, hw, span in clouds:
        keys = rng.integers(0, hw, (B, n))
        keys[:, -n // 12:] = hw  # invalid points
        if what == "all-invalid image":
            keys[0] = hw
        if span and not what.startswith("flat"):  # one cell of exactly `span` points an image
            keys[keys == 777] = hw
            keys[:, :span] = 777
        keys = np.sort(keys, axis=1)
        if what.startswith("flat"):  # the run of one cell from a window's edge
            for b, p0 in ((0, 2 * windows[0]), (1, 3 * windows[1] - 3)):
                c = int(keys[b, p0])
                keys[b, :p0][keys[b, :p0] == c] = c - 1
                keys[b, p0:p0 + span] = c
                after = keys[b, p0 + span:]
                after[after == c] = c + 1
        f = np.round(rng.normal(0, 1, (B, n, C)) * 4) / 4
        f[1] = -np.abs(f[1]) - 0.25
        feats = torch.from_numpy(f.astype(np.float32)).to(dev, dtype)
        keys_d = torch.from_numpy(keys.astype(np.int32)).to(dev)
        got = ss.segment_max(feats, keys_d, hw)
        want = ss.segment_max_plain(feats, keys_d, hw)
        _, lib = scatter_library(feats, keys_d, hw)
        if not (torch.equal(got, want) and torch.equal(got, lib)):
            raise AssertionError(f"scatter_sorted_fwd {what} {dtype}: not bit-exact")
        for large in (True, False):
            with flat_stage(large):
                flat = ss.segment_max_flat(feats, keys_d, hw)
            if not (torch.equal(flat, want) and torch.equal(flat, lib)
                    and torch.equal(flat, got)):
                raise AssertionError(f"scatter_sorted_fwd_flat {what} {dtype} (stage of "
                                     f"{'FLAT_SLOT_BYTES' if large else 'FLAT_SLOT_BYTES_SMALL'})"
                                     f": not bit-exact")
        g = torch.from_numpy(rng.normal(0, 1, (B, hw, C)).astype(np.float32)).to(dev, dtype)
        if not torch.equal(ss.segment_max_bwd(feats, keys_d, got, g, hw),
                           ss.segment_max_bwd_plain(feats, keys_d, got, g, hw)):
            raise AssertionError(f"scatter_sorted_bwd {what} {dtype}: not exact")
        if dev.type != "cuda":
            out[what] = "checked"
            continue
        plans = {"fwd": ss.segment_max_plan(B, n, C, hw, dtype),
                 "bwd": ss.segment_max_bwd_plan(B, n, C, hw, dtype)}
        for kind, pl in plans.items():
            geo = ss.walk_geometry(C, es, kind)
            if ((pl["vector_bytes"], pl["lanes"], pl["walkers"], pl["rows_per_step"],
                 pl["long_span_chunk_rows"], pl["slices"])
                    != (geo["vec"], geo["lanes"], geo["walkers"], geo["cap"], geo["long_rows"],
                        geo["slices"])):
                raise AssertionError(f"scatter_sorted_{kind} {what}: plan {pl} is not {geo}")
        for large in (True, False):
            with flat_stage(large):
                plans["flat" if large else "flat_small_stage"] = flat_plan(B, n, C, hw, dtype)
        out[what] = plans
    return out


def nan_features(rng, keys, hw, C, dtype, dev):
    """Features for the NaN clouds: quarters of N(0, 1) (every zero +0.0:
    which zero a max of -0.0 and +0.0 gives is not part of the contract,
    and K6's edge clouds hold the signs of zero), image 1 all negative, and
    NaN of both signs at about 1 in 2,000 elements, at the last point of
    each image's longest run and at the first point of its second longest."""
    B, N = keys.shape
    f = np.round(rng.normal(0, 1, (B, N, C)) * 4) / 4 + 0.0
    f[1] = -np.abs(f[1]) - 0.25
    hit = rng.random((B, N, C)) < 5e-4
    f[hit] = np.where(rng.random(int(hit.sum())) < 0.5, np.nan, -np.nan)
    for b in range(B):
        cells, first, counts = np.unique(keys[b], return_index=True, return_counts=True)
        order = [i for i in np.argsort(-counts) if cells[i] < hw]
        f[b, first[order[0]] + counts[order[0]] - 1, 3] = np.nan
        f[b, first[order[1]], 5] = -np.nan
    return torch.from_numpy(f.astype(np.float32)).to(dev, dtype)


def check_nan_scatter(rng, dev, dtype, B=2) -> dict:
    """The NaN contract of the scatter kernels (the JAX package's xla route:
    a cell holding a NaN is NaN, and the NaN stays in its cell), on
    cell-sorted clouds with NaN features (nan_features): the uniform and the
    skewed cloud of the kernel phase and the 2,000-point window run of
    check_sorted_scatter_edges. K1, K4 (with each stage size) and K6 (on
    the points permuted) must equal their plain versions and each other,
    NaN at the same places and
    every other element bit for bit (same_bits_nan), and K6 its keyed
    reference; K5 on K1's output must equal its plain version exactly (a
    NaN cell ties no point: its points get 0). The plain versions run on
    the CPU: CUDA's scatter_reduce_ amax is not relied on to keep a NaN
    (whether it does is printed)."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    from lmsu_tpu_torch.ops import voxelize as vx
    hw = GRID * GRID
    out = {}
    cpu = torch.device("cpu")
    for what in ("uniform", "skewed", "flat window run 2000"):
        if what == "flat window run 2000":
            keys = np.sort(rng.integers(0, hw, (B, NPTS)), axis=1)
            keys[:, -NPTS // 12:] = hw
            window = ss.flat_geometry(128, 4 if dtype == torch.float32 else 2)["window_rows"]
            p0, c = 2 * window, int(keys[0, 2 * window])
            keys[:, :p0][keys[:, :p0] == c] = c - 1
            keys[:, p0:p0 + 2000] = c
            tail = keys[:, p0 + 2000:]
            tail[tail == c] = c + 1
            keys = torch.from_numpy(np.sort(keys, axis=1).astype(np.int32)).to(dev)
        else:
            _, keys = sorted_inputs(rng, 8, dtype, dev, B, skew=what == "skewed")
        feats = nan_features(rng, keys.cpu().numpy(), hw, 128, dtype, dev)
        want = ss.segment_max_plain(feats.to(cpu), keys.to(cpu), hw)
        res = {"k1": ss.segment_max(feats, keys, hw),
               "k4_plain": ss.segment_max_flat_plain(feats.to(cpu), keys.to(cpu), hw)}
        for large in (True, False):
            with flat_stage(large):
                res["k4" if large else "k4_small_stage"] = ss.segment_max_flat(feats, keys, hw)
        perm = torch.from_numpy(rng.permutation(NPTS)).to(dev)
        fp, kp = feats[:, perm].contiguous(), keys[:, perm].contiguous()
        res["k6"] = vx.scatter_max(fp, kp, hw)
        res["k6_plain"] = vx.scatter_max_plain(fp.to(cpu), kp.to(cpu), hw)
        res["k6_keyed"] = keyed_scatter_max(fp, kp, hw)
        for name, got in res.items():
            if not same_bits_nan(got.to(cpu), want):
                raise AssertionError(f"NaN cloud {what} {dtype}: {name} != segment_max_plain "
                                     f"(NaN {int(torch.isnan(got).sum())} vs "
                                     f"{int(torch.isnan(want).sum())})")
        _, lib = scatter_library(fp, kp, hw)
        g = torch.from_numpy(rng.normal(0, 1, (B, hw, 128)).astype(np.float32)).to(dev, dtype)
        d = ss.segment_max_bwd(feats, keys, res["k1"], g, hw)
        d_want = ss.segment_max_bwd_plain(feats.to(cpu), keys.to(cpu), want, g.to(cpu), hw)
        if not torch.equal(d.to(cpu), d_want):
            raise AssertionError(f"NaN cloud {what} {dtype}: scatter_sorted_bwd not exact")
        out[what] = {"nan_inputs": int(torch.isnan(feats).sum()),
                     "nan_cells": int(torch.isnan(want).sum()),
                     "cuda_scatter_reduce_keeps_nan": same_bits_nan(lib.to(cpu), want)}
    return out


@contextlib.contextmanager
def flat_stage(large: bool):
    """While on, K4 plans every call with the larger stage (FLAT_SLOT_BYTES,
    the KD step's B=128) or with the smaller one (FLAT_SLOT_BYTES_SMALL,
    serving's B=8), whatever the call's size, so that both are checked on
    the edge clouds."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    before = ss.FLAT_WINDOWS_A_BLOCK
    ss.FLAT_WINDOWS_A_BLOCK = 0 if large else 1 << 30
    ss._FLAT_PLANS.clear()
    try:
        yield
    finally:
        ss.FLAT_WINDOWS_A_BLOCK = before
        ss._FLAT_PLANS.clear()


def check_nan_dense(rng, dev, dtype, Bn=2) -> dict:
    """The NaN contract of the kernels with a ReLU or ReLU6 (K2's gate
    ReLU, relu6 of K3 and K9-K12): on inputs holding a few NaN, each keeps
    NaN exactly where its plain version, run on the CPU, keeps it, and
    agrees elsewhere within check_close (check_close_nan). K2 at
    cam/lid [2, 64, 64, 128]; K3 at the student's five stages; K8-K13
    through each of the student's five fused InvertedResidual blocks in
    train mode (f32 only, as check_fused_blocks; a NaN input makes the
    batch statistics NaN, so every output and gradient is NaN in the plain
    module: a kernel that drops NaN gives finite values there)."""
    import copy
    from lmsu_tpu_torch.models.layers import InvertedResidual
    from lmsu_tpu_torch.ops import fusion_gate as fg
    from lmsu_tpu_torch.ops import ir_fused as irf
    cpu = torch.device("cpu")
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731

    def with_nan(a):
        a = np.asarray(a, np.float32).copy()
        hit = rng.random(a.shape) < 2e-5
        hit.flat[rng.integers(0, a.size)] = True
        a[hit] = np.where(rng.random(int(hit.sum())) < 0.5, np.nan, -np.nan)
        return a

    C = 128
    cam = t(with_nan(rng.normal(0, 1, (Bn, GRID, GRID, C)))).to(dtype)
    lid = t(with_nan(rng.normal(0, 1, (Bn, GRID, GRID, C)))).to(dtype)
    ws = (t(rng.normal(0, 0.08, (C, 2 * C, 1, 1))), t(rng.normal(0, 0.1, (C,))),
          t(rng.normal(0, 0.1, (2, C, 1, 1))), t(rng.normal(0, 0.1, (2,))))
    want = fg.fusion_gate_plain(cam.to(cpu), lid.to(cpu), *(w.to(cpu) for w in ws))
    got = fg.fusion_gate(cam, lid, *ws)
    out = {"fusion_gate": {"max_abs_err": check_close_nan("fusion_gate NaN", got.to(cpu), want,
                                                          dtype),
                           "nan_out": int(torch.isnan(want).sum())}}
    out["ir_fused_infer"] = []
    for H, Cin, Cout, stride, exp in IR_STAGES:
        x = t(with_nan(rng.uniform(0, 3, (Bn, H, H, Cin)))).to(dtype)
        p = random_ir_params(rng, dev, Cin, Cout, exp)
        p_cpu = irf.IRParams(*(None if v is None else v.to(cpu) for v in p))
        want = irf.fused_ir_infer_plain(x.to(cpu), p_cpu, stride)
        err = check_close_nan(f"ir_fused_infer NaN {H}x{Cin}->{Cout}/s{stride}",
                              irf.fused_ir_infer(x, p, stride).to(cpu), want, dtype)
        out["ir_fused_infer"].append({"stage": f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}",
                                      "max_abs_err": err, "nan_out": int(torch.isnan(want).sum())})
    if dtype != torch.float32:
        return out
    out["fused_blocks"] = []
    gen = torch.Generator().manual_seed(23)
    for H, Cin, Cout, stride, exp in IR_STAGES:
        torch.manual_seed(23)
        m = InvertedResidual(Cin, Cout, stride, exp, fused_train=True)
        randomize_bn(m, 23)
        m.train()
        x = torch.from_numpy(with_nan(torch.rand(Bn, Cin, H, H, generator=gen).numpy() * 3))
        dy = torch.randn(Bn, Cout, H // stride, H // stride, generator=gen)
        res = {}
        for where in (dev, cpu):
            mi = copy.deepcopy(m).to(where)
            xi = x.to(where).requires_grad_(True)
            y = mi(xi)
            y.backward(dy.to(where))
            res[where.type] = {"out": y.detach(), "dx": xi.grad,
                               **{f"grad {k}": q.grad for k, q in mi.named_parameters()},
                               **{k: v for k, v in mi.named_buffers()
                                  if not k.endswith("num_batches_tracked")}}
        stage = f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}"
        worst = 0.0
        for k, want in res["cpu"].items():
            got = res[dev.type][k].to(cpu)
            if k.startswith("grad ") or k == "dx" or k == "out":
                worst = max(worst, check_close_nan(f"fused block NaN {stage} {k}", got, want,
                                                   dtype, scaled=True, some=k == "out"))
            elif not torch.equal(torch.isnan(got), torch.isnan(want)):
                raise AssertionError(f"fused block NaN {stage} {k}: NaN at other places")
        out["fused_blocks"].append({"stage": stage, "max_abs_err": worst,
                                    "nan_out": int(torch.isnan(res["cpu"]["out"]).sum())})
    return out


def kernel_kd_mse(rng, dev, dtype, B=B, M=GRID * GRID, cs=128, ct=256):
    """K7 against its plain version: per-sample sums of (S - T.P)^2, on a
    random student and on a near-teacher one (S = T.P + 1e-3 N(0, 1), a
    student that matches its projected teacher, as late in distillation;
    rounded to bf16 in bf16), both within 1e-5 relative. The noise comes from
    a generator of its own, so the other kernels' inputs stay as they were."""
    from lmsu_tpu_torch.ops import kd_loss
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    s3 = t(rng.normal(0, 1, (B, M, cs))).to(dtype)
    t3 = t(rng.normal(0, 1, (B, M, ct))).to(dtype)
    p = t(rng.normal(0, 1 / np.sqrt(ct), (ct, cs)))
    noise = t(np.random.default_rng(7).normal(0, 1, (B, M, cs)))
    near = (t3.float() @ p + 1e-3 * noise).to(dtype)
    del noise
    errs = {}
    for kind, s in (("random", s3), ("near_teacher", near)):
        got = kd_loss.mse_partials(s, t3, p)
        want = kd_loss.mse_partials_plain(s, t3, p)
        err = (got - want).abs().max().item()
        # Sums of M*Cs f32 squares in another order, T.P from split bf16
        # terms on the tensor cores: relative 1e-5.
        if not (torch.isfinite(got).all() and err <= 1e-5 * want.abs().max().item()):
            raise AssertionError(f"kd_feature_mse {dtype} {kind}: max abs err {err:g} of "
                                 f"{want.abs().max().item():g}")
        errs[kind] = {"max_abs_err": err, "rel_err": err / want.abs().max().item()}
    del near
    pl = p.to(dtype)

    def library():
        return torch.nn.functional.mse_loss(s3, torch.matmul(t3, pl), reduction="sum")

    es = s3.element_size()
    nbytes = B * M * (cs + ct) * es + ct * cs * 4 + B * 4
    # The products the design issues (split bf16 terms: 6 for f32 taps, 3
    # for bf16) at the bf16 tensor-core peak, against the bytes.
    products = kd_loss.kernel_products(dtype)
    bound, by = bound_ms(nbytes, products * 2 * B * M * ct * cs + 3 * B * M * cs,
                         torch.bfloat16)
    run = lambda: kd_loss.mse_partials(s3, t3, p)  # noqa: E731
    return {"ms": time_ms(run), "eager_ms": eager_ms(run),
            "plain_ms": time_ms(lambda: kd_loss.mse_partials_plain(s3, t3, p)),
            "library_ms": time_ms(library), "library": "torch.matmul + F.mse_loss",
            "bound_ms": bound, "bound_by": by, "max_abs_err": errs["random"]["max_abs_err"],
            "near_teacher": errs["near_teacher"], "bf16_products": products,
            "shape": f"S [{B},{M},{cs}], T [{B},{M},{ct}], P [{ct},{cs}]"}


def kernel_gate(rng, dev, dtype, C=128, B=B):
    """K2 against its plain version at cam/lid [B, 64, 64, C]. Bound: the
    products the kernel issues on the tensor cores (fusion_gate.gate_products
    per f32-level product: 6 for f32 features, 3 for bf16, W1 being f32 in
    both) at 989 TFLOP/s beside the epilogue's CUDA-core work (bias, ReLU,
    the logit's multiply-add, the blend: 8 operations a row and channel) at
    67 TFLOP/s, the larger of the two, against the bytes (cam, lid read,
    out written, the f32 weights read)."""
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
    tc = fg.gate_products(dtype) * 2 * M * 2 * C * C
    t_ops = max(tc / PEAK_OPS[torch.bfloat16], 8 * M * C / PEAK_OPS[torch.float32]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    r = {"ms": time_ms(lambda: fg.fusion_gate(*args)),
         "eager_ms": eager_ms(lambda: fg.fusion_gate(*args)),
         "plain_ms": time_ms(lambda: fg.fusion_gate_plain(*args)),
         "library_ms": None, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
         "bf16_products": fg.gate_products(dtype),
         "shape": f"cam/lid [{B},{GRID},{GRID},{C}], w1 [{C},{2 * C}]"}
    if dev.type == "cuda":
        lib, code = fg.KERNEL.lib(), 0 if dtype == torch.float32 else 1
        r.update(tile_rows=lib.fusion_gate_rows(C, code), warps=lib.fusion_gate_warps(C, code),
                 streams=lib.fusion_gate_streams(C, code), smem_bytes=lib.fusion_gate_smem(C, code),
                 blocks_per_sm=lib.fusion_gate_occupancy(C, code))
        log(f"[kernels] fusion_gate C={C} {dtype}: tiles of {r['tile_rows']} rows, "
            f"{r['smem_bytes']} bytes of shared memory a block, {r['blocks_per_sm']} blocks of "
            f"{r['warps']} warps per SM")
    if C == 512:
        log(f"[kernels] fusion_gate C=512 B={B} {dtype}: {r['ms']:.4f} ms against the plain "
            f"version's {r['plain_ms']:.4f} ms (no slower: {r['ms'] <= r['plain_ms']})")
    return r


def check_gate_widths(rng, dev, dtype, B=2, widths=(40, 42, 44, 642, 1100, 1104)):
    """K2 against its plain version (check_close, with both timed at B=2)
    at C off the main path: 40 and 44 pad each half of K to 48 channels; 42,
    642 and in bf16 44 and 1,100 have rows that are not 16-byte multiples
    (staged and blended element by element); past a 32-row tile's shared
    memory (642, 1,100 and 1,104 in f32, 1,100 and 1,104 in bf16) x streams
    through the kernel's ring. At least one width must stream."""
    from lmsu_tpu_torch.ops import fusion_gate as fg
    lib, code = fg.KERNEL.lib(), 0 if dtype == torch.float32 else 1
    out = {}
    for C in widths:
        M = B * GRID * GRID
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        cam = t(rng.uniform(-2, 2, (B, GRID, GRID, C))).to(dtype)
        lid = t(rng.uniform(-2, 2, (B, GRID, GRID, C))).to(dtype)
        args = (cam, lid, t(rng.normal(0, (2 * C) ** -0.5, (C, 2 * C, 1, 1))),
                t(rng.normal(0, 0.1, C)), t(rng.normal(0, C ** -0.5, (2, C, 1, 1))),
                t(rng.normal(0, 0.1, 2)))
        err = check_close(f"fusion_gate C={C}", fg.fusion_gate(*args),
                          fg.fusion_gate_plain(*args), dtype)
        out[C] = {"rows": M, "max_abs_err": err, "streams": lib.fusion_gate_streams(C, code),
                  "tile_rows": lib.fusion_gate_rows(C, code),
                  "ms": time_ms(lambda: fg.fusion_gate(*args)),
                  "plain_ms": time_ms(lambda: fg.fusion_gate_plain(*args))}
    if not any(r["streams"] == 1 for r in out.values()):
        raise AssertionError(f"no width streamed x through K2's ring: {out}")
    return out


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


def ir_infer_bound(Bn, H, Cin, Cout, stride, exp, dtype) -> tuple:
    """K3's bound: its 1x1 products on the bf16 tensor cores
    (ir_fused.mma_products per f32-level product) at 989 TFLOP/s, beside the
    depthwise on CUDA cores at 67 TFLOP/s (the units overlap: the larger),
    against reading x and the weights once and writing the output once."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    Ce, Ho = Cin * exp, (H - 1) // stride + 1
    es = 4 if dtype == torch.float32 else 2
    wbytes = ((Cin * Ce if exp != 1 else 0) + Ce * Cout) * es + (9 * Ce + 4 * Ce + 2 * Cout) * 4
    nbytes = Bn * H * H * Cin * es + Bn * Ho * Ho * Cout * es + wbytes
    tc = irf.mma_products(dtype) * 2 * Bn * (H * H * Cin * Ce * (exp != 1) + Ho * Ho * Ce * Cout)
    cuda = 2 * 9 * Bn * Ho * Ho * Ce
    t_ops = max(tc / PEAK_OPS[torch.bfloat16], cuda / PEAK_OPS[torch.float32]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        bound, by = ir_infer_bound(B, H, Cin, Cout, stride, exp, dtype)
        plan = (irf.infer_plan(B, H, H, Cin, Cin * exp, Cout, stride, exp != 1, dtype)
                if dev.type == "cuda" else None)
        st = {"stage": f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}", "plan": plan,
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


IR_INFER_EDGES = [  # (H, Cin, Cout, stride, expansion), checked at B=2
    (16, 36, 36, 1, 6), (16, 20, 44, 2, 6),  # widths: multiples of 4, not of 16
    # the 2x teacher's five stages at 256^2 (the fourth 128 -> 256 at stride 2 included)
    (128, 64, 64, 1, 1), (128, 64, 128, 2, 6), (64, 128, 128, 1, 6), (64, 128, 256, 2, 6),
    (32, 256, 256, 1, 6)]


def check_ir_infer_edges(rng, dev, dtype, Bn=2) -> dict:
    """K3 against its plain version (check_close) off the student's stages:
    IR_INFER_EDGES, each with its launch plan; and in bf16 on
    ir_fused.infer_rounding_probe, where K3 must give the plain version's
    and fused_ir_infer_emulated's output bit for bit, 3 + 2^-6 in channel 0
    (e is not rounded before BN1)."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    out = {}
    for H, Cin, Cout, stride, exp in IR_INFER_EDGES:
        x = torch.from_numpy(rng.uniform(0, 3, (Bn, H, H, Cin)).astype(np.float32)).to(dev, dtype)
        p = random_ir_params(rng, dev, Cin, Cout, exp)
        what = f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}"
        err = check_close(f"ir_fused_infer {what}", irf.fused_ir_infer(x, p, stride),
                          irf.fused_ir_infer_plain(x, p, stride), dtype)
        plan = (irf.infer_plan(Bn, H, H, Cin, Cin * exp, Cout, stride, exp != 1, dtype)
                if dev.type == "cuda" else None)
        out[what] = {"max_abs_err": err, "plan": plan}
    if dtype == torch.bfloat16:
        x, prm = irf.infer_rounding_probe()
        xb = x.to(dev, dtype)
        p = irf.IRParams(*(a.to(dev) for a in prm))
        got, want = irf.fused_ir_infer(xb, p, 1), irf.fused_ir_infer_plain(xb, p, 1)
        if not (same_bits(got, want) and same_bits(got, irf.fused_ir_infer_emulated(xb, p, 1))
                and bool((got[..., 0].float() == 3 + 2.0 ** -6).all())):
            raise AssertionError(f"ir_fused_infer rounding probe: {got[0, 0, 0].tolist()} vs "
                                 f"{want[0, 0, 0].tolist()}")
        out["rounding probe"] = "bit-exact, 3 + 2^-6"
    return out


def check_masked(name, got, want, dtype, frac=1e-5):
    """K12's dv1: as check_close(scaled=True), except at up to `frac` of the
    elements where one side is exactly 0. K12 recomputes e = x @ W1 in its
    own summation order, so where v1 = e * s1 + b1 lies within f32 rounding
    of 0 or 6 its strict ReLU6 mask can differ from the plain version's.
    Returns (max abs error elsewhere, number of such elements)."""
    diff = (got.float() - want.float()).abs()
    scale = max(1.0, want.float().abs().max().item())
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
    bad = diff > tol
    flips = int(bad.sum().item())
    one_zero = (got[bad] == 0) | (want[bad] == 0)
    if not (flips <= frac * got.numel() and bool(one_zero.all())
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} [{dtype}]: {flips} elements off by more than {tol:g}, "
                             f"max {diff.max().item():g}")
    return diff.masked_fill(bad, 0).max().item(), flips


def dw1_float64_error(x, w1, m1, inv1, u1, p1, q1, dv1, plain_dw1):
    """K13's dW1 and its plain version's (`plain_dw1`) against dW1 = x^T de
    in float64 on the card (e = x W1 and de = u1 dv1 - p1 - q1 (e - m1) inv1
    in float64, from the same f32 inputs): each one's max abs difference over
    max(1, max |dW1|)."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    cin, ce = x.shape[-1], dv1.shape[-1]
    _, dw1 = irf.expand_bwd(x, w1, m1, inv1, u1, p1, q1, dv1)
    xm = x.reshape(-1, cin).double()
    de = xm @ w1.double()
    de.sub_(m1.double()).mul_(inv1.double() * -q1.double()).sub_(p1.double())
    de.add_(dv1.reshape(-1, ce).double() * u1.double())
    ref = xm.T @ de
    del xm, de
    scale = max(1.0, ref.abs().max().item())
    return ((dw1.double() - ref).abs().max().item() / scale,
            (plain_dw1.double() - ref).abs().max().item() / scale)


def dw2_float64_error(d, dy, s2, b2, dw2, plain_dw2):
    """K11's dW2 (`dw2`) and its plain version's (`plain_dw2`) against dW2 =
    d_act^T dy in float64 on the card (d_act = relu6(d s2 + b2) in float64,
    from the same f32 inputs): each one's max abs difference over max(1,
    max |dW2|)."""
    ce, cout = d.shape[-1], dy.shape[-1]
    d_act = d.reshape(-1, ce).double().mul_(s2.double()).add_(b2.double()).clamp_(0.0, 6.0)
    ref = d_act.T @ dy.reshape(-1, cout).double()
    del d_act
    scale = max(1.0, ref.abs().max().item())
    return ((dw2.double() - ref).abs().max().item() / scale,
            (plain_dw2.double() - ref).abs().max().item() / scale)


def check_proj_bwd_edges(rng, dev, dtype) -> dict:
    """K11 on the card at what the student's stages do not reach. (a) Ties:
    stage 2's widths (Ce 192, Cout 64) at B=2 with v2 = d s2 + b2 exactly 0
    in channels 0-7 and exactly 6 in channels 8-23: dv2 must be zero exactly
    where the plain version's is (all of channels 0-23), and every output
    within check_close's limits. (b) Cout in chunks: Ce 768 -> Cout 1000
    (wider than a group of W2^T's fragments takes in shared memory, in both
    types; the last chunk ragged) on 16,384 pixels, so that each block walks
    several tiles and chunks: K10 and K11 against their plain versions, and
    in f32 K11's dW2 within 1e-4 of scale of float64; K11 and its plain
    version timed there."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    code = 0 if dtype == torch.float32 else 1
    out = {}
    m, ce, cout = 2 * 64 * 64, 192, 64
    d = rng.normal(0, 2, (m, ce)).astype(np.float32)
    s2, b2 = rng.uniform(0.5, 1.5, ce).astype(np.float32), rng.normal(0, 0.2, ce).astype(np.float32)
    s2[:8], s2[8:16], s2[16:24] = 1.0, 1.0, 0.5
    d[:, 8:16], b2[8:16] = 4.0, 2.0
    d[:, 16:24], b2[16:24] = 12.0, 0.0
    d[:, :8] = d[0, :8]
    d = t(d).to(dtype)
    s2, b2 = t(s2), t(b2)
    b2[:8] = -d[0, :8].float()
    v2 = d.float() * s2 + b2
    if not ((v2[:, :8] == 0).all() and (v2[:, 8:24] == 6).all()):
        raise AssertionError("check_proj_bwd_edges: the tie inputs do not give v2 = 0 and 6")
    dy = t(rng.normal(0, 1, (m, cout))).to(dtype)
    m2, inv2 = d.float().mean(0), torch.rsqrt(d.float().var(0, unbiased=False) + 1e-5)
    w2 = t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)))
    args = (d, dy, s2, b2, m2, inv2, w2)
    got, want = irf.proj_bwd(*args), irf.proj_bwd_plain(*args)
    errs = [check_close(f"proj_bwd ties {k}", g, w, dtype, scaled=True)
            for k, g, w in zip(("dv2", "dW2", "ra", "rb"), got, want)]
    zero, zero_plain = got[0] == 0, want[0] == 0
    passed = zero[:, 24:].logical_not().float().mean().item()
    if not (zero[:, :24].all() and torch.equal(zero, zero_plain) and passed > 0.3):
        raise AssertionError(f"proj_bwd ties [{dtype}]: dv2's zeros differ from the plain "
                             f"version's ({int((zero != zero_plain).sum())} elements)")
    out["ties"] = {"max_abs_err": max(errs), "dv2_zero_mismatch": 0,
                   "nonzero_share_random_channels": passed}

    m, ce, cout = 16384, 768, 1000
    d = t(rng.normal(0, 1, (m, ce))).to(dtype)
    s2, b2 = t(rng.uniform(0.5, 1.5, ce)), t(rng.normal(0, 0.2, ce))
    m2, inv2 = d.float().mean(0), torch.rsqrt(d.float().var(0, unbiased=False) + 1e-5)
    dy = t(rng.normal(0, 1, (m, cout))).to(dtype)
    w2 = t(rng.normal(0, np.sqrt(2.0 / ce), (ce, cout)))
    args = (d, dy, s2, b2, m2, inv2, w2)
    y_err = check_close("proj chunks", irf.proj(d, s2, b2, w2), irf.proj_plain(d, s2, b2, w2),
                        dtype, scaled=True)
    got, want = irf.proj_bwd(*args), irf.proj_bwd_plain(*args)
    errs = [check_close(f"proj_bwd chunks {k}", g, w, dtype, scaled=True)
            for k, g, w in zip(("dv2", "dW2", "ra", "rb"), got, want)]
    lib = irf.PROJ_BWD.lib()
    chunks = {"channel_groups": lib.ir_train_proj_bwd_groups(ce, cout, code),
              "cout_chunks": lib.ir_train_proj_bwd_chunks(ce, cout, code),
              "spans": lib.ir_train_proj_bwd_rows(m, ce, cout, code),
              "smem_bytes": lib.ir_train_proj_bwd_smem(ce, cout, code)}
    if chunks["cout_chunks"] < 2:
        raise AssertionError(f"proj_bwd chunks [{dtype}]: Cout={cout} ran in one chunk")
    f64 = None
    if dtype == torch.float32:
        f64, _ = dw2_float64_error(d, dy, s2, b2, got[1], want[1])
        if not f64 <= 1e-4:
            raise AssertionError(f"proj_bwd chunks dW2: {f64:g} of scale from float64")
    out["chunks"] = {"shape": [m, ce, cout], "proj_max_abs_err": y_err,
                     "max_abs_err": max(errs), "dw2_float64_rel_err": f64,
                     "ms": time_ms(lambda: irf.proj_bwd(*args), reps=5, inner=2),
                     "plain_ms": time_ms(lambda: irf.proj_bwd_plain(*args), reps=3, inner=1),
                     **chunks}
    del got, want, args, d, dy
    torch.cuda.empty_cache()
    return out


def _ir_train_inputs(rng, dev, dtype, H, Cin, Cout, stride, exp, B):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    Ce = Cin * exp
    x = t(rng.uniform(0, 3, (B, H, H, Cin))).to(dtype)  # a ReLU6 output, as in the model
    w1 = t(rng.normal(0, np.sqrt(2.0 / Cin), (Cin, Ce))) if exp != 1 else None
    dw = t(rng.normal(0, np.sqrt(2.0 / 9), (3, 3, Ce)))
    w2 = t(rng.normal(0, np.sqrt(2.0 / Ce), (Ce, Cout)))
    gb = [t(rng.uniform(0.5, 1.5, c)) if i % 2 == 0 else t(rng.normal(0, 0.2, c))
          for i, c in enumerate((Ce, Ce, Ce, Ce, Cout, Cout))]
    dy = t(rng.normal(0, 1, (B, H // stride, H // stride, Cout))).to(dtype)
    return x, w1, dw, w2, gb, dy


def kernel_ir_train(rng, dev, dtype, B=TRAIN_B, stages=IR_STAGES, timed=True):
    """K8-K13 against their plain versions at every stage of the student at
    batch B (or at `stages`; untimed, without the block yardstick, when not
    `timed`), each kernel on the inputs the plain chain gives it (batch
    statistics, BN folds and the vectors of _ir_train_backward), and each
    stage's fused forward + backward against the port's unfused block
    (cuDNN convs, train-mode BatchNorm) on the same input: the JAX package's
    own yardstick (scripts/profile_roofline.py:173-186). Bounds: each input
    read once, each output written once. K8-K13 run their 1x1 products on
    the bf16 tensor cores: their bounds count the products they issue there
    (ir_fused.mma_products: 6 per f32 product, 1 per bf16) at 989 TFLOP/s,
    beside their elementwise work on CUDA cores at 67 TFLOP/s (K8's
    rounding, squares and sums, the depthwise of K9 and K12, BN2 + ReLU6 of
    K10 and K11; the larger of the two, as the units overlap), against the
    bytes.

    Also, at every stage with an expand: K9 and K12 must compute the same e
    bit for bit (each kernel's probe writes the e of its own staging and
    tiling; the count of differing elements is printed and must be 0), K8's
    e is compared with K9's the same way (the count is printed), and
    in f32 K13's dW1 must be within 1e-4 of scale of a float64 dW1 computed
    on the card from the same inputs; at every stage, so must K11's f32 dW2
    of a float64 dW2. K10's and K11's (and K12's) shared memory a block and
    resident blocks per SM are printed for each stage."""
    from lmsu_tpu_torch.models.layers import InvertedResidual
    from lmsu_tpu_torch.ops import ir_fused as irf
    out = {k: {"stages": []} for k in IR_TRAIN_KERNELS}
    blocks = []
    es = 4 if dtype == torch.float32 else 2
    products = irf.mma_products(dtype)
    for H, Cin, Cout, stride, exp in stages:
        Ce, Ho, has = Cin * exp, H // stride, exp != 1
        M1, M2 = B * H * H, B * Ho * Ho
        stage = f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}"
        x, w1, dw, w2, (g1, be1, g2, be2, g3, be3), dy = _ir_train_inputs(
            rng, dev, dtype, H, Cin, Cout, stride, exp, B)

        def record(name, run, plain, checks, nbytes, ops=None, tc=None, cuda=None, **extra):
            if ops is not None:
                bound, by = bound_ms(nbytes, ops, dtype)
            else:  # tensor-core products and CUDA-core work, overlapping
                t_ops = max(tc / PEAK_OPS[torch.bfloat16], cuda / PEAK_OPS[torch.float32]) * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            st = {"stage": stage, "ms": time_ms(run, reps=10, inner=3) if timed else None,
                  "plain_ms": time_ms(plain, reps=3, inner=1) if timed else None,
                  "bound_ms": bound, "bound_by": by, "max_abs_err": max(checks), **extra}
            out[name]["stages"].append(st)
            torch.cuda.empty_cache()

        e8 = (torch.full((B, H, H, Ce), float("nan"), device=dev)
              if has and dev.type == "cuda" else None)
        if has:
            args = (x, w1)
            got, want = irf.stats1(*args, probe=e8), irf.stats1_plain(*args)
            errs = [check_close(f"stats1 {stage} {k}", g, w, dtype, scaled=True)
                    for k, g, w in zip(("sum", "sq"), got, want)]
            k8 = {}
            if dev.type == "cuda":
                lib, code = irf.STATS1.lib(), 0 if dtype == torch.float32 else 1
                k8 = {"smem_bytes": lib.ir_train_stats1_smem(Cin, Ce, code),
                      "blocks_per_sm": lib.ir_train_stats1_occupancy(Cin, Ce, code)}
                log(f"[kernels] ir_train_stats1 {stage} {dtype}: {k8['smem_bytes']} bytes of "
                    f"shared memory a block, {k8['blocks_per_sm']} blocks of 8 warps per SM")
            # The expand on the tensor cores (mma_products per f32-level
            # product) beside rounding, squaring and summing each e on CUDA
            # cores.
            record("ir_train_stats1", lambda: irf.stats1(*args),
                   lambda: irf.stats1_plain(*args), errs,
                   M1 * Cin * es + Cin * Ce * 4 + 2 * Ce * 4,
                   tc=products * 2 * M1 * Cin * Ce, cuda=3 * M1 * Ce, **k8)
            m1, v1 = irf._bn_stats_finalize(*want, M1)
            inv1 = torch.rsqrt(v1 + 1e-5)
            s1, b1 = irf.fold_bn(g1, be1, m1, v1)
        else:
            s1 = b1 = m1 = inv1 = None

        args = (x, w1, s1, b1, dw, stride)
        e9 = (torch.full((B, H, H, Ce), float("nan"), device=dev)
              if has and dev.type == "cuda" else None)
        got, want = irf.expand_dw(*args, probe=e9), irf.expand_dw_plain(*args)
        errs = [check_close(f"expand_dw {stage} {k}", g, w, dtype, scaled=True)
                for k, g, w in zip(("d", "sum", "sq"), got, want)]
        if e8 is not None:
            # K8's e against K9's, bit for bit: printed, not a gate (K8 is
            # held by its sums).
            e8_diff = int((e8.view(torch.int32) != e9.view(torch.int32)).sum().item())
            log(f"[kernels] e of K8 vs K9 {stage} {dtype}: {e8_diff} elements differ")
            out["ir_train_stats1"]["stages"][-1]["e_diff_vs_k9"] = e8_diff
            del e8
        k9 = {}
        if dev.type == "cuda":
            lib, code = irf.EXPAND_DW.lib(), 0 if dtype == torch.float32 else 1
            k9 = {"smem_bytes": lib.ir_train_expand_dw_smem(Cin, stride, int(has), code),
                  "blocks_per_sm": lib.ir_train_expand_dw_occupancy(Cin, stride, int(has), code)}
        record("ir_train_expand_dw", lambda: irf.expand_dw(*args),
               lambda: irf.expand_dw_plain(*args), errs,
               M1 * Cin * es + M2 * Ce * es + (Cin * Ce * has + 13 * Ce) * 4,
               tc=products * 2 * M1 * Cin * Ce * has, cuda=18 * 2 * M2 * Ce, **k9)
        d = want[0]
        m2, v2 = irf._bn_stats_finalize(want[1], want[2], M2)
        inv2 = torch.rsqrt(v2 + 1e-5)
        s2, b2 = irf.fold_bn(g2, be2, m2, v2)
        del got, want

        code = 0 if dtype == torch.float32 else 1
        args = (d, s2, b2, w2)
        errs = [check_close(f"proj {stage}", irf.proj(*args), irf.proj_plain(*args), dtype,
                            scaled=True)]
        k10 = {}
        if dev.type == "cuda":
            lib = irf.PROJ.lib()
            k10 = {"smem_bytes": lib.ir_train_proj_smem(Ce, Cout, code),
                   "blocks_per_sm": lib.ir_train_proj_occupancy(Ce, Cout, code)}
            log(f"[kernels] ir_train_proj {stage} {dtype}: {k10['smem_bytes']} bytes of shared "
                f"memory a block, {k10['blocks_per_sm']} blocks of 8 warps per SM")
        # The product on the tensor cores (mma_products per f32-level
        # product) beside BN2 + ReLU6 of each d element on CUDA cores.
        record("ir_train_proj", lambda: irf.proj(*args), lambda: irf.proj_plain(*args), errs,
               M2 * Ce * es + M2 * Cout * 4 + (Ce * Cout + 2 * Ce) * 4,
               tc=products * 2 * M2 * Ce * Cout, cuda=4 * M2 * Ce, **k10)

        args = (d, dy, s2, b2, m2, inv2, w2)
        got, want = irf.proj_bwd(*args), irf.proj_bwd_plain(*args)
        errs = [check_close(f"proj_bwd {stage} {k}", g, w, dtype, scaled=True)
                for k, g, w in zip(("dv2", "dW2", "ra", "rb"), got, want)]
        f64 = f64_plain = None
        if dtype == torch.float32:
            f64, f64_plain = dw2_float64_error(d, dy, s2, b2, got[1], want[1])
            log(f"[kernels] proj_bwd {stage} dW2 vs float64: {f64:g} of scale (limit 1e-4; "
                f"plain version {f64_plain:g})")
            if not f64 <= 1e-4:
                raise AssertionError(f"proj_bwd {stage} dW2: {f64:g} of scale from float64")
        k11 = {}
        if dev.type == "cuda":
            lib = irf.PROJ_BWD.lib()
            k11 = {"smem_bytes": lib.ir_train_proj_bwd_smem(Ce, Cout, code),
                   "blocks_per_sm": lib.ir_train_proj_bwd_occupancy(Ce, Cout, code),
                   "channel_groups": lib.ir_train_proj_bwd_groups(Ce, Cout, code),
                   "cout_chunks": lib.ir_train_proj_bwd_chunks(Ce, Cout, code)}
            log(f"[kernels] ir_train_proj_bwd {stage} {dtype}: {k11['channel_groups']} channel "
                f"groups, {k11['smem_bytes']} bytes of shared memory a block, "
                f"{k11['blocks_per_sm']} blocks of 16 warps per SM")
        # Two products (dd_hat, dW2) on the tensor cores beside d_act, the
        # mask, dv2, dn and the two sums of each d element on CUDA cores.
        record("ir_train_proj_bwd", lambda: irf.proj_bwd(*args),
               lambda: irf.proj_bwd_plain(*args), errs,
               2 * M2 * Ce * es + M2 * Cout * es + (2 * Ce * Cout + 6 * Ce) * 4,
               tc=products * 2 * 2 * M2 * Ce * Cout, cuda=12 * M2 * Ce,
               dw2_float64_rel_err=f64, plain_dw2_float64_rel_err=f64_plain, **k11)
        dv2, r2a, r2b = want[0], want[2], want[3]
        del got, want
        u2 = g2 * inv2
        p2, q2 = u2 * (r2a / M2), u2 * (r2b / M2)

        args = (x, w1, s1, b1, m1, inv1, dw, dv2, u2, p2, q2, d, m2, inv2, stride)
        e12 = torch.full_like(e9, float("nan")) if e9 is not None else None
        got, want = irf.dw_bwd(*args, probe=e12), irf.dw_bwd_plain(*args)
        e_diff = None
        if e9 is not None:
            # K9's and K12's e, bit for bit (NaN, never written, differs too).
            e_diff = int((e9.view(torch.int32) != e12.view(torch.int32)).sum().item())
            log(f"[kernels] e of K9 vs K12 {stage} {dtype}: {e_diff} elements differ")
            if e_diff:
                raise AssertionError(f"K9 and K12 e differ at {e_diff} elements ({stage}, "
                                     f"{dtype})")
            del e9
        err_dv1, flips = check_masked(f"dw_bwd {stage} dv1", got[0], want[0], dtype)
        log(f"[kernels] dw_bwd {stage} {dtype}: {flips} ReLU6 mask flips against the plain "
            f"version")
        errs = [err_dv1,
                check_close(f"dw_bwd {stage} dDW", got[1], want[1], dtype, scaled=True)]
        if has:
            e, _, _ = irf._expand_act(x, w1, s1, b1)
            en_max = ((e - m1) * inv1).abs().max().item()
            # Every element whose ReLU6 mask differs (exactly one side 0,
            # however small the other), not only those check_masked counts:
            # each moves ra by its dv1 and rb by at most that times max|en|
            # (1.01: dv1 is compared as stored, the sums take it unrounded).
            g0, w0 = got[0].float(), want[0].float()
            differ = (g0 == 0) != (w0 == 0)
            moved = 1.01 * torch.maximum(g0.abs(), w0.abs())[differ].sum().item()
            mask_diffs = int(differ.sum().item())
            # Where the kernel's e (its probe) rounds to another value of the
            # input dtype than the plain version's, rb's term moves by dv1
            # times the difference in en: 1.01 * sum |dv1| |de| inv1.
            e_moved = 0.0
            if e12 is not None:
                e_moved = 1.01 * (torch.maximum(g0.abs(), w0.abs())
                                  * (e12 - e).abs() * inv1).sum().item()
            del g0, w0, differ, e, e12
            log(f"[kernels] dw_bwd {stage} {dtype}: {mask_diffs} elements with the other ReLU6 "
                f"mask (any size), moving ra by at most {moved:g}")
            for k, g, w, f, ex in (("ra", got[2], want[2], 1.0, 0.0),
                                   ("rb", got[3], want[3], en_max, e_moved)):
                err = (g - w).abs().max().item()
                tol = 1e-4 * max(1.0, w.abs().max().item()) + moved * f + ex
                if not err <= tol:
                    raise AssertionError(f"dw_bwd {stage} {k} [{dtype}]: {err:g} > {tol:g}")
                errs.append(err)
        # K12's shared memory per block and resident blocks per SM at this
        # stage (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
        smem = per_sm = None
        if dev.type == "cuda":
            lib, code = irf.DW_BWD.lib(), 0 if dtype == torch.float32 else 1
            smem = lib.ir_train_dw_bwd_smem(Cin, stride, int(has), code)
            per_sm = lib.ir_train_dw_bwd_occupancy(Cin, stride, int(has), code)
            log(f"[kernels] ir_train_dw_bwd {stage} {dtype}: {smem} bytes of shared memory "
                f"a block, {per_sm} blocks of 8 warps per SM")
        record("ir_train_dw_bwd", lambda: irf.dw_bwd(*args), lambda: irf.dw_bwd_plain(*args),
               errs, M1 * Cin * es + 2 * M2 * Ce * es + M1 * Ce * es
               + (Cin * Ce * has + 19 * Ce) * 4,
               tc=products * 2 * M1 * Cin * Ce * has, cuda=36 * 2 * M2 * Ce, mask_flips=flips,
               mask_diffs=mask_diffs if has else 0, e_diff_vs_k9=e_diff, smem_bytes=smem,
               blocks_per_sm=per_sm)
        dv1, r1a, r1b = want[0], want[2], want[3]
        del got, want

        if has:
            u1 = g1 * inv1
            args = (x, w1, m1, inv1, u1, u1 * (r1a / M1), u1 * (r1b / M1), dv1)
            got, want = irf.expand_bwd(*args), irf.expand_bwd_plain(*args)
            errs = [check_close(f"expand_bwd {stage} {k}", g, w, dtype, scaled=True)
                    for k, g, w in zip(("dx", "dW1"), got, want)]
            f64 = f64_plain = None
            if dtype == torch.float32:
                f64, f64_plain = dw1_float64_error(*args, want[1])
                log(f"[kernels] expand_bwd {stage} dW1 vs float64: {f64:g} of scale "
                    f"(limit 1e-4; plain version {f64_plain:g})")
                if not f64 <= 1e-4:
                    raise AssertionError(f"expand_bwd {stage} dW1: {f64:g} of scale from "
                                         f"float64")
            del got, want
            ngroups = smem13 = None
            if dev.type == "cuda":
                lib, code = irf.EXPAND_BWD.lib(), 0 if es == 4 else 1
                ngroups = lib.ir_train_expand_bwd_groups(Cin, Ce, code)
                smem13 = lib.ir_train_expand_bwd_smem(Cin, Ce, code)
            record("ir_train_expand_bwd", lambda: irf.expand_bwd(*args),
                   lambda: irf.expand_bwd_plain(*args), errs,
                   M1 * Cin * es + M1 * Ce * es + M1 * Cin * 4 + (2 * Cin * Ce + 5 * Ce) * 4,
                   tc=3 * products * 2 * M1 * Cin * Ce, cuda=0, dw1_float64_rel_err=f64,
                   plain_dw1_float64_rel_err=f64_plain, dx_partials=ngroups,
                   smem_bytes=smem13)
        del args, d, dv2, dv1
        if not timed:
            continue

        # The block yardstick: fused forward + backward vs the unfused block.
        block = InvertedResidual(Cin, Cout, stride, exp).to(dev).train()
        with torch.no_grad():
            c = list(block.conv)
            convs = [m for m in c if isinstance(m, torch.nn.Conv2d)]
            bns = [m for m in c if isinstance(m, torch.nn.BatchNorm2d)]
            if has:
                convs[0].weight.copy_(w1.t()[:, :, None, None])
            convs[-2].weight.copy_(dw.permute(2, 0, 1)[:, None])
            convs[-1].weight.copy_(w2.t()[:, :, None, None])
            for bn, (g, be) in zip(bns, ([(g1, be1)] if has else []) + [(g2, be2), (g3, be3)]):
                bn.weight.copy_(g)
                bn.bias.copy_(be)
        xs = x.detach().requires_grad_(True)
        xc = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        dyc = dy.permute(0, 3, 1, 2).contiguous()
        leaves = [(w1 if has else torch.zeros(Cin, Ce, device=dev)).clone().requires_grad_(True),
                  (g1 if has else torch.zeros(Ce, device=dev)).clone().requires_grad_(True),
                  (be1 if has else torch.zeros(Ce, device=dev)).clone().requires_grad_(True)] + [
            a.clone().requires_grad_(True) for a in (dw, g2, be2, w2, g3, be3)]

        def fused():
            o, _ = irf.fused_ir_train(xs, *leaves, stride, has)
            o.backward(dy)

        def unfused():
            block(xc).backward(dyc)

        blocks.append({"stage": stage, "fused_ms": eager_ms(fused, reps=5, inner=1),
                       "unfused_ms": eager_ms(unfused, reps=5, inner=1)})
        del block, xs, xc, leaves, x, dy
        torch.cuda.empty_cache()
    if not timed:
        return out, blocks
    for name, r in out.items():
        for k in ("ms", "plain_ms", "bound_ms"):
            r[k] = sum(st[k] for st in r["stages"])
        r["max_abs_err"] = max(st["max_abs_err"] for st in r["stages"])
        r["bound_by"] = ("operations" if any(st["bound_by"] == "operations"
                                              for st in r["stages"]) else "bytes")
        r["library_ms"] = None
        r["shape"] = (f"the student's {len(r['stages'])} InvertedResidual stages at B={B}, "
                      f"256^2 input; times summed over them")
    return out, blocks


def phase_kernels(dev):
    """Each kernel at the shapes of its main paths: serving at B=8 (K1, K2,
    K4, K6 at the student's C=128) and the KD step at B=128 (K1, K2, K4, K6
    at C=128 for the student and C=256 for the 2x teacher, K5 and K7, and
    K8-K13 at the student's five stages); K5 and K7 at B=8 too; K4 and K6
    (with K1 beside K4) and K5 at B=128 also on the skewed cloud
    ("<kind>_skew"). Keys:
    (kernel, dtype, C, batch)."""
    rng = np.random.default_rng(0)
    # K4 and K6 draw from a stream of their own, so that the other kernels'
    # inputs stay those of the runs before them.
    rng_k4_k6 = np.random.default_rng(4)
    rng_c512 = np.random.default_rng(512)
    rng_k5_skew = np.random.default_rng(5)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        runs = [("scatter", C, b, kernel_scatter) for b in (B, TRAIN_B) for C in (128, 256)]
        runs += [("scatter_bwd", 128, b, kernel_scatter_bwd) for b in (B, TRAIN_B)]
        runs += [("kd_mse", 256, b, kernel_kd_mse) for b in (B, TRAIN_B)]
        # K2 also at C=512 (a 4x teacher; inputs from a stream of its own).
        runs += [("gate", 128, B, kernel_gate), ("gate", 128, TRAIN_B, kernel_gate),
                 ("gate", 256, TRAIN_B, kernel_gate), ("gate", 512, B, kernel_gate)]
        for kind, fn in (("voxelize", kernel_unsorted), ("scatter_flat", kernel_flat)):
            runs += [(kind + tag, C, b, fn) for tag in ("", "_skew")
                     for b, C in ((B, 128), (TRAIN_B, 128), (TRAIN_B, 256))]
        runs.append(("scatter_bwd_skew", 128, TRAIN_B, kernel_scatter_bwd))
        for kind, C, b, fn in runs:
            kw = {"B": b} if kind == "kd_mse" else {"C": C, "B": b}
            if kind.endswith("_skew"):
                kw["skew"] = True
            src = (rng_k4_k6 if fn in (kernel_unsorted, kernel_flat)
                   else rng_k5_skew if kind == "scatter_bwd_skew"
                   else rng_c512 if C == 512 else rng)
            r = fn(src, dev, dtype, **kw)
            res[(kind, name, C, b)] = r
            log(f"[kernels] {kind} {name} C={C} B={b}: {json.dumps(r)}")
            del r
            torch.cuda.empty_cache()
        res[("ir", name, 0, B)] = kernel_ir(rng, dev, dtype)
        log(f"[kernels] ir_fused_infer {name}: {json.dumps(res[('ir', name, 0, B)])}")
        edges = check_ir_infer_edges(np.random.default_rng(36), dev, dtype)
        log(f"[kernels] ir_fused_infer other widths and the teacher {name}, B=2: "
            f"{json.dumps(edges)}")
        edges = check_voxelize_edges(np.random.default_rng(4999), dev, dtype)
        log(f"[kernels] voxelize_scatter_max edge clouds {name}, B=2: {json.dumps(edges)}")
        edges = check_sorted_scatter_edges(np.random.default_rng(1010), dev, dtype)
        log(f"[kernels] scatter_sorted_fwd/fwd_flat/bwd edge clouds {name}, B=2: "
            f"{json.dumps(edges)}")
        nan = check_nan_scatter(np.random.default_rng(1111), dev, dtype)
        log(f"[kernels] NaN clouds, K1 K4 K5 K6 {name}, B=2: {json.dumps(nan)}")
        nan = check_nan_dense(np.random.default_rng(2222), dev, dtype)
        log(f"[kernels] NaN inputs, K2 K3 and the fused blocks {name}, B=2: {json.dumps(nan)}")
        irt, blocks = kernel_ir_train(rng, dev, dtype)
        for k, r in irt.items():
            res[(k, name, 0, TRAIN_B)] = r
            log(f"[kernels] {k} {name} B={TRAIN_B}: {json.dumps(r)}")
        # K8-K13's paths for wide blocks, checked (not timed) at B=2 on inputs
        # of their own: the 2x teacher's last stage (K13 walks Cin in two
        # register groups) and Cin 256 at stride 2 (K9 stages the halo in
        # slices of Cin, K12 takes it through its ring).
        wide, _ = kernel_ir_train(np.random.default_rng(256), dev, dtype, B=2, timed=False,
                                  stages=[(16, 256, 256, 1, 6), (32, 256, 256, 2, 6)])
        log(f"[kernels] K8-K13 wide blocks {name}, B=2: " + json.dumps(
            {k: [(st["stage"], st["max_abs_err"]) for st in r["stages"]] for k, r in wide.items()}))
        widths = check_gate_widths(np.random.default_rng(40), dev, dtype)
        log(f"[kernels] fusion_gate other widths {name}, B=2: {json.dumps(widths)}")
        edges = check_proj_bwd_edges(np.random.default_rng(711), dev, dtype)
        log(f"[kernels] K11 at ties and with Cout in chunks {name}: {json.dumps(edges)}")
        res[("ir_block", name, 0, TRAIN_B)] = blocks
        log(f"[kernels] fused vs unfused block fwd+bwd {name} B={TRAIN_B}: "
            f"{json.dumps(blocks)}")
    return res


# -- serving phase -----------------------------------------------------------


def serving_config(dtype, kernels=True, scatter="sorted_pallas"):
    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    return ModelConfig(
        num_classes=2, fusion_type="weighted", fusion_out_channels=128,
        use_pallas_fusion=kernels,
        camera=CameraEncoderConfig(fused_inference=kernels),
        lidar=LidarEncoderConfig(scatter_impl=scatter if kernels else "xla"),
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


@contextlib.contextmanager
def fwd_flat(on: bool = True):
    """While on, the sorted scatter's forward is the flat kernel K4, split
    by points (the JAX package's _FWD_FLAT switch), instead of K1."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    before = ss._FWD_FLAT
    ss._FWD_FLAT = on
    try:
        yield
    finally:
        ss._FWD_FLAT = before


def phase_serving(dev, dtype, state_dict=None, scatter="sorted_pallas", n_frames=32):
    """With scatter="sorted_pallas" K1 (K4 under fwd_flat) serves the
    scatter, with "pallas" K6; of the three scatter kernels only that one
    may launch, and with "pallas" no host sort runs."""
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.serving import ServingEngine, make_server
    name = "f32" if dtype == torch.float32 else "bf16"
    scatter_kernel = ("voxelize_scatter_max" if scatter == "pallas" else
                      "scatter_sorted_fwd_flat" if ss._FWD_FLAT else "scatter_sorted_fwd")
    if scatter_kernel != "scatter_sorted_fwd":
        name = f"{name} {scatter_kernel}"
    pred = Predictor(serving_config(dtype, scatter=scatter), state_dict, device=dev, seed=0)
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
        frames = make_frames(rng, n_frames)
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
        need = ("fusion_gate", "ir_fused_infer", scatter_kernel)
        if (any(launches[k] <= 0 for k in need)
                or any(launches[k] for k in SCATTER_KERNELS if k != scatter_kernel)):
            raise AssertionError(f"{name}: launches while serving: {launches}")
        if scatter == "pallas" and (pred._sorter is not None or engine._sorter is not None):
            raise AssertionError("the pallas scatter takes points unsorted; a sorter is set")

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


# -- train phase -------------------------------------------------------------


def train_config(dtype, kernels=True, batch=TRAIN_B, save_dir=None, fused_train=False,
                 scatter="sorted_pallas"):
    """The KD student step of bench.py: the weighted/128 student, the 2x
    teacher, AdamW lr 1e-3 (constant: eta_min = lr) and wd 1e-3, class
    weights (0.4, 3.5), the three default taps; kernels on (with the
    scatter `scatter`) or off; the student's InvertedResidual stages fused
    in training (K8-K13) or not."""
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig)
    model = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128,
                        use_pallas_fusion=kernels,
                        camera=CameraEncoderConfig(fused_train=fused_train),
                        lidar=LidarEncoderConfig(scatter_impl=scatter if kernels else "xla"),
                        compute_dtype=dtype)
    train = TrainConfig(lr=1e-3, eta_min=1e-3, weight_decay=1e-3, class_weights=(0.4, 3.5),
                        kd=KDConfig(enabled=True, use_pallas=kernels),
                        save_dir=save_dir or os.path.join("build", "train_smoke"))
    return ExperimentConfig(model=model, data=DataConfig(batch_size=batch), train=train)


def train_batch(rng, batch, dev, sort=True):
    """bench.py's fixed batch: uniform images, N(0, 30) points with z in
    [-5, 3], random labels; the points sorted by BEV cell on the host
    unless `sort` is off (the loaders sort for sorted_pallas only)."""
    from lmsu_tpu_torch.data.rasterize import bev_cell_key
    pts = rng.normal(0, 30, (batch, NPTS, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-5, 3, (batch, NPTS))
    if sort:
        key = bev_cell_key(pts, (GRID, GRID), (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0))
        pts = np.take_along_axis(pts, np.argsort(key, axis=-1, kind="stable")[..., None], 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return {"image": t(rng.uniform(0, 1, (batch, IMG, IMG, 3)).astype(np.float32)),
            "points": t(pts), "segmentation": t(rng.integers(0, 2, (batch, GRID, GRID)))}


@contextlib.contextmanager
def fused_twins(on: bool = True):
    """While on, fused_ir_train runs K8-K13's plain versions in the kernels'
    place on any device (the wrappers take them only for CPU tensors)."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    names = ("stats1", "expand_dw", "proj", "proj_bwd", "dw_bwd", "expand_bwd")
    wrappers = {n: getattr(irf, n) for n in names}
    try:
        if on:
            for n in names:
                setattr(irf, n, getattr(irf, n + "_plain"))
        yield
    finally:
        for n, f in wrappers.items():
            setattr(irf, n, f)


def check_fused_blocks(dev):
    """Each of the student's five InvertedResidual stages as a module in
    train mode, f32, at the step check's batch B (input uniform in [0, 3),
    seeded weights, randomised BatchNorms, a seeded output cotangent):
    InvertedResidual(fused_train=True) against the same module with
    K8-K13's plain versions on the card in the kernels' place ("twins"), and
    against the unfused module (cuDNN convs, train-mode BatchNorm:
    "unfused"), from the same state. Errors: the output and every BN running
    mean and variance after the step as max|d| / max|want| ("forward"); the
    input gradient and every parameter gradient as relative L2 ("grad"),
    because where v = e * s + b lies within rounding of 0 or 6 the two sides'
    strict ReLU6 masks can differ at single elements, which moves the
    maximum but not the norm. num_batches_tracked must be equal. One block
    holds one BatchNorm backward per BN, not the KD step's chain of them, so
    the limits are fixed: forward 1e-5 (f32 sums in another order read
    ~1e-6 on the H100 at B=8 and B=128), gradients 1e-2 against either side
    (read up to ~2e-3: the BN weights' gradients sum dv1 * en over the
    batch, and each element whose mask differs moves that sum by one term).
    A fault that moves any gradient by 1% or a running statistic by 1e-5 of
    its scale fails."""
    import copy
    from lmsu_tpu_torch.models.layers import InvertedResidual
    limits = {"forward": 1e-5, "grad": 1e-2}
    gen = torch.Generator().manual_seed(17)
    report, bad = [], []
    for H, Cin, Cout, stride, exp in IR_STAGES:
        stage = f"{H}x{H} {Cin}->{Cout} s{stride} e{exp}"
        torch.manual_seed(17)
        fused = InvertedResidual(Cin, Cout, stride, exp, fused_train=True)
        randomize_bn(fused, 17)
        fused = fused.to(dev).train()
        x = (torch.rand(B, Cin, H, H, generator=gen) * 3).to(dev)
        dy = torch.randn(B, Cout, H // stride, H // stride, generator=gen).to(dev)
        res = {}
        for run in ("fused", "twins", "unfused"):
            m = copy.deepcopy(fused)
            m.fused_train = run != "unfused"
            xi = x.clone().requires_grad_(True)
            with fused_twins(run == "twins"):
                y = m(xi)
                y.backward(dy)
            res[run] = {"out": y.detach(), "dx": xi.grad,
                        **{f"grad {k}": p.grad for k, p in m.named_parameters()},
                        **{k: v.clone() for k, v in m.named_buffers()}}
        st = {"stage": stage}
        for run in ("twins", "unfused"):
            worst = {"forward": (0.0, ""), "grad": (0.0, "")}
            for k, want in res[run].items():
                got = res["fused"][k]
                if k.endswith("num_batches_tracked"):
                    if not torch.equal(got, want):
                        bad.append(f"{stage} vs {run}: {k} {got.item()} != {want.item()}")
                    continue
                d = (got - want).double()
                if k == "dx" or k.startswith("grad "):
                    kind, e = "grad", (d.norm() / want.double().norm().clamp_min(1e-30)).item()
                else:
                    kind = "forward"
                    e = d.abs().max().item() / max(want.abs().max().item(), 1e-30)
                if not (e <= limits[kind] and torch.isfinite(got).all()):
                    bad.append(f"{stage} vs {run}: {k} err {e:g} > {limits[kind]:g}")
                worst[kind] = max(worst[kind], (e, k))
            st[f"vs_{run}"] = {f"{kind}_worst": w for kind, w in worst.items()}
        report.append(st)
        del res, fused
    if bad:
        raise AssertionError(f"fused blocks at B={B}: {bad}; {report}")
    return {"batch": B, "limits": limits, "stages": report}


def kd_step(dev, batch, cfg, perturb: float = 0.0, twins: bool = False):
    """One KD step from the trainer's seeded weights, times (1 + perturb xi)
    with xi ~ N(0, 1) when `perturb`: (loss, every gradient, every BN
    running statistic after the step), in float64. With `twins`,
    fused_ir_train runs K8-K13's plain versions on the card in the kernels'
    place (the wrappers take them only for CPU tensors)."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    from lmsu_tpu_torch.training import DistillationTrainer
    tr = DistillationTrainer(cfg, [batch], [batch], device=dev)
    if perturb:
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in tr.params.values():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(dev))
    with fused_twins(twins):
        loss, _ = tr.train_step(batch)
    stats = {k: v.detach().double() for k, v in tr.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss), {k: p.grad.detach().double() for k, p in tr.params.items()}, stats


GATE_W1 = "model.fusion.attention.0.weight"  # the student's fused gate's W1


@contextlib.contextmanager
def gate_backward_taps(taps: list):
    """While on, each backward of the fused gate (fusion_gate_bwd) also
    appends to `taps` what a jump of its ReLU mask is made of, by the
    backward's own expressions on its own inputs: the mask a > 0 [M, C], dd
    (the loss's derivative by the gate's logit) [M], w2d [C] and [cam | lid]
    [M, 2C], f32."""
    from lmsu_tpu_torch.ops import fusion_gate as fg
    bwd = fg.fusion_gate_bwd

    def tapped(cam, lid, w1, b1, w2, b2, g_out):
        with torch.no_grad():
            C = cam.shape[-1]
            camf, lidf = cam.reshape(-1, C).float(), lid.reshape(-1, C).float()
            go = g_out.reshape(-1, C).float()
            w = w1.reshape(C, 2 * C).float()
            w2f = w2.reshape(2, C).float()
            w2d = w2f[0] - w2f[1]
            a = camf @ w[:, :C].T + lidf @ w[:, C:].T + b1.float()
            g = torch.sigmoid(torch.relu(a) @ w2d + (b2[0] - b2[1]).float())
            dd = (go * (camf - lidf)).sum(-1) * (g * (1.0 - g))
            taps.append({"mask": a > 0, "dd": dd, "w2d": w2d, "x": torch.cat([camf, lidf], 1)})
        return bwd(cam, lid, w1, b1, w2, b2, g_out)

    fg.fusion_gate_bwd = tapped
    try:
        yield
    finally:
        fg.fusion_gate_bwd = bwd


def gate_jump(got: dict, want: dict, shape) -> tuple:
    """The part of the gate's W1 gradient by which step `got` differs from
    step `want` because their ReLU masks differ: ((M_got - M_want) * dd
    w2d^T)^T [cam | lid], from got's dd, w2d and [cam | lid] (taps of
    gate_backward_taps), in float64, in W1's shape; and how many mask
    entries differ."""
    flip = got["mask"].double() - want["mask"].double()
    da = flip * (got["dd"].double()[:, None] * got["w2d"].double()[None, :])
    return (da.T @ got["x"].double()).reshape(shape), int(flip.abs().sum().item())


def hold_step(what, got, want, noise=None, jumps=None) -> dict:
    """Hold KD step `got` against `want`, each as kd_step returns it:
      loss              |d| <= 1e-5 |loss|;
      all gradients     relative L2 <= 1e-3;
      each gradient     max|d| <= 1e-2 max|g| + 1e-6 G, G the largest
                        gradient of any tensor;
      each BN running mean and variance after the step
                        max|d| <= 1e-4 max|s| + 1e-6.
    With `noise` (the `want` step from perturbed weights), each limit gains
    ten times want's own spread N (|noise - want|, measured alike), capped:
    loss min(10 N, 1e-4 |loss|), relative L2 min(10 N, 0.1), each gradient
    min(10 N, 0.1 max|g|), each statistic min(10 N, 1e-2 max|s|). With
    `jumps` ({gradient name: J}), that gradient's difference less J is held
    to its limit (J: gate_jump's part of the difference that the steps'
    differing ReLU masks make); the relative L2 over all gradients keeps
    the whole difference. Raises on the first quantity over its limit;
    returns the errors."""
    (la, ga, sa), (lb, gb, sb) = got, want
    jumps = jumps or {}
    lp, gp, sp = want if noise is None else noise   # no noise: spread 0
    err = abs(la - lb)
    if not err <= 1e-5 * abs(lb) + min(10 * abs(lp - lb), 1e-4 * abs(lb)):
        raise AssertionError(f"{what}: loss {la} != {lb} (perturbed {lp})")
    gmax = max(g.abs().max().item() for g in gb.values())
    sq = {k: ((ga[k] - gb[k]) ** 2).sum().item() for k in gb}
    norm = sum((g ** 2).sum().item() for g in gb.values()) ** 0.5
    rel = sum(sq.values()) ** 0.5 / norm
    spread = sum(((gp[k] - gb[k]) ** 2).sum().item() for k in gb) ** 0.5 / norm
    top = sorted(sq, key=lambda k: -sq[k])[:4]
    out = {"loss": la, "loss_want": lb, "loss_abs_err": err, "grad_rel_l2_err": rel,
           "params": len(gb), "largest_diffs": {
               k: {"l2_diff": sq[k] ** 0.5, "l2": (gb[k] ** 2).sum().item() ** 0.5} for k in top}}
    if noise is not None:
        out.update({"loss_perturbed": lp, "grad_rel_l2_spread": spread})
    if not rel <= 1e-3 + min(10 * spread, 0.1):
        raise AssertionError(f"{what}: gradients' relative L2 error {rel:g}: {out}")
    worst = {}
    for kind, got_t, want_t, noise_t, fixed_of, cap in (
            ("grad", ga, gb, gp, lambda s: 1e-2 * s + 1e-6 * gmax, 0.1),
            ("bn_stat", sa, sb, sp, lambda s: 1e-4 * s + 1e-6, 1e-2)):
        worst[kind] = (0.0, "")
        for k in want_t:
            d = got_t[k] - want_t[k]
            if kind == "grad" and k in jumps:
                out.setdefault("jumps", {})[k] = {
                    "err": d.abs().max().item(), "jump_max": jumps[k].abs().max().item()}
                d = d - jumps[k]
                out["jumps"][k]["err_less_jump"] = d.abs().max().item()
            e = d.abs().max().item()
            scale = want_t[k].abs().max().item()
            fixed = fixed_of(scale)
            tol = fixed + min(10 * (noise_t[k] - want_t[k]).abs().max().item(), cap * scale)
            if not e <= tol:
                raise AssertionError(f"{what}: {kind} {k}: err {e:g} > {tol:g}")
            worst[kind] = max(worst[kind], (e / fixed, k))
        out.update({f"{kind}_worst_err_over_fixed_limit": worst[kind][0],
                    f"{kind}_worst": worst[kind][1]})
    out["bn_stats"] = len(sb)
    return out


def check_kernel_vs_plain_step(dev, scatter="sorted_pallas"):
    """One f32 KD step at B=8, TF32 off: the kernel path (sorted scatter
    K1+K5, or with scatter="pallas" the unsorted scatter K6 with the dense
    backward; fused gate K2, fused feature MSE K7) against the plain path
    (unsorted scatter_reduce with autograd, unfused softmax gate,
    kd_total_loss) from the same weights and the same cell-sorted batch,
    held to hold_step's fixed limits. The two differ in f32 rounding only.
    Why the gradient limits are so wide: the first LiDAR MLP layer's weight
    gradient sums, over 40k points, raw coordinates (|x| up to ~100) times
    BatchNorm-centred gradients, so its rounding moves with any change of
    summation order, and the two scatters order the points differently. The
    G term is for the biases that a train-mode BatchNorm follows: their true
    gradient is 0 and both paths give rounding noise. Both scatters get the
    same cell-sorted batch (the pallas one takes any order), so the two
    checks differ by the scatter alone."""
    rng = np.random.default_rng(11)
    batch = train_batch(rng, B, dev)
    return hold_step(f"KD step, kernel path ({scatter}) vs plain path",
                     kd_step(dev, batch, train_config(torch.float32, True, B, scatter=scatter)),
                     kd_step(dev, batch, train_config(torch.float32, False, B)))


def check_fused_step(dev):
    """The fused training path (CameraEncoderConfig.fused_train, every other
    kernel opt-in on) at B=8, f32, TF32 off, deterministic cuDNN:
      blocks  check_fused_blocks at B=8, the step's shapes: each stage's
              module against K8-K13's plain versions and against the
              unfused module, at fixed limits. This is the tight check.
      step    one KD step from the same weights and batch, held by
              hold_step (a) against the same fused step with the plain
              versions in the kernels' place, and (b) against the unfused
              step (cuDNN convs, train-mode BatchNorm). The step amplifies
              f32 rounding: the gradients of the convs that a train-mode
              BatchNorm follows are sums that cancel, so the plain-version
              step moves its gradients by ~4e-3 relative L2 when the weights
              move by 1e-7 of themselves, and the unfused step by ~1e-2
              under 1e-6. So each comparison adds ten times that spread, of
              the plain-version step under 1e-7 for (a) and of the unfused
              step under 1e-6 for (b) (hold_step's `noise`); the fused and
              unfused paths also differ by design (E[x^2] - E[x]^2
              statistics, ReLU6 derivative 0 at exact ties where unfused
              gives 1/2).
    The gate's W1 gradient also moves by jumps: where a pre-activation of
    the fused gate sits within rounding of 0, the two steps' ReLU masks in
    the gate's backward can differ, and each differing entry moves a row of
    that gradient by dd w2d [cam | lid], which no perturbation of the
    weights need reproduce. Each step's gate backward is tapped
    (gate_backward_taps), the differing entries are counted, and their
    exact part of the difference (gate_jump) is taken out of that one
    gradient before it is held to its limit."""
    blocks = check_fused_blocks(dev)
    rng = np.random.default_rng(13)
    batch = train_batch(rng, B, dev)
    cfg = lambda fused: train_config(torch.float32, True, B, fused_train=fused)  # noqa: E731

    def tapped_step(**kw):
        taps = []
        with gate_backward_taps(taps):
            step = kd_step(dev, batch, **kw)
        if len(taps) != 1:
            raise AssertionError(f"the student's gate ran {len(taps)} backwards in one step")
        return step, taps[0]

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fused, fused_tap = tapped_step(cfg=cfg(True))
        twins, twins_tap = tapped_step(cfg=cfg(True), twins=True)
        twins_p = kd_step(dev, batch, cfg(True), twins=True, perturb=1e-7)
        unfused, unfused_tap = tapped_step(cfg=cfg(False))
        unfused_p = kd_step(dev, batch, cfg(False), perturb=1e-6)
    finally:
        torch.backends.cudnn.deterministic = det
    shape = fused[1][GATE_W1].shape
    jump_a, flips_a = gate_jump(fused_tap, twins_tap, shape)
    jump_b, flips_b = gate_jump(fused_tap, unfused_tap, shape)
    log(f"[train] fused step's gate ReLU mask: {flips_a} entries differ from the "
        f"plain-version step's, {flips_b} from the unfused step's")
    del fused_tap, twins_tap, unfused_tap
    return {"blocks": blocks,
            "gate_mask_flips": {"vs_plain_versions": flips_a, "vs_unfused": flips_b},
            "step_vs_plain_versions": hold_step(
                "fused KD step vs the same step with K8-K13's plain versions", fused, twins,
                noise=twins_p, jumps={GATE_W1: jump_a}),
            "step_vs_unfused": hold_step("fused KD step vs unfused step", fused, unfused,
                                         noise=unfused_p, jumps={GATE_W1: jump_b})}


def profile_steps(step, reps: int = 2):
    """Device time by kernel over `reps` steps (torch.profiler) and the
    share of the steps' wall time the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    ours = {n: sum(r[1] for r in rows if n in r[0])
            for n in ("scatter_sorted_fwd_kernel", "scatter_sorted_fwd_flat_kernel",
                      "voxelize_scatter_max_kernel", "scatter_sorted_bwd", "fusion_gate",
                      "kd_mse_tc", "kd_mse_reduce", "stats1_kernel", "expand_dw_kernel",
                      "proj_kernel", "proj_bwd_kernel", "dw_bwd_kernel",
                      "expand_bwd_kernel", "colsum_kernel")}
    return {"wall_ms": wall, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall), "our_kernels_ms": ours,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:15]]}


def phase_train(dev, dtype, warmup: int = 3, steps: int = 10, variants=("in_loop", "cached"),
                fused_train=False, scatter="sorted_pallas"):
    """The KD step at B=128 through DistillationTrainer.train_step on one
    fixed batch: in-loop teacher, then cached teacher (its outputs computed
    once for the batch, bench.py:233-244); with fused_train, the student's
    InvertedResidual stages run K8-K13; with scatter="pallas" the scatter
    is K6 on points in their own order. Launches of each kernel per step
    are counted over the timed steps; the loss must fall over them."""
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.training import DistillationTrainer
    name = "f32" if dtype == torch.float32 else "bf16"
    tag = " ".join([name] + (["fused_train"] if fused_train else [])
                   + ([scatter] if scatter != "sorted_pallas" else []))
    rng = np.random.default_rng(5)
    batch = train_batch(rng, TRAIN_B, dev, sort=scatter == "sorted_pallas")
    torch.cuda.reset_peak_memory_stats(dev)
    tr = DistillationTrainer(train_config(dtype, fused_train=fused_train, scatter=scatter),
                             [batch], [batch], device=dev)
    out = {}
    for variant in variants:
        t_out = tr.teacher_forward(batch) if variant == "cached" else None
        step = lambda: tr.train_step(batch, teacher_out=t_out)  # noqa: E731
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(step()[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = {k: v.launches for k, v in kernels().items()}
        losses = [float(v) for v in losses]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train {name} {variant}: loss did not fall: {losses}")
        out[variant] = {"step_ms": step_ms, "frames_per_s": TRAIN_B / step_ms * 1e3,
                        "losses": losses, "launches": launches,
                        "launches_per_step": {k: n / steps for k, n in launches.items()},
                        "profile": profile_steps(step)}
        log(f"[train {tag}] {variant}: {json.dumps(out[variant])}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["loss_parts"] = tr.last_loss_parts
    log(f"[train {tag}] peak device memory {out['peak_mem_gb']:.3f} GB; last loss parts "
        f"{json.dumps(out['loss_parts'])}")
    return out


def run_train_cli(dev):
    """The training entry point on the card: one epoch of synthetic data at
    full width with the slice's kernels, history and checkpoints written."""
    import tempfile

    from lmsu_tpu_torch import train_distill
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    with tempfile.TemporaryDirectory() as d:
        reset_launch_counts()
        t0 = time.perf_counter()
        best = train_distill.main(["--device", str(dev), "--epochs", "1", "--batch-size", "32",
                                   "--num-train", "64", "--num-val", "32", "--num-workers", "4",
                                   "--scatter-impl", "sorted_pallas", "--use-pallas-fusion",
                                   "--use-pallas-kd", "--save-dir", d])
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(d))
        launches = {k: v.launches for k, v in kernels().items()}
        for f in ("training_history.json", "latest.pth", "best.pth"):
            if f not in files and not (f == "best.pth" and best == 0.0):
                raise AssertionError(f"train_distill wrote {files}, not {f}")
    return {"seconds": secs, "best_val_miou": best, "files": files, "launches": launches}


# -- main --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="kernels,serving,train",
                    help="comma list of kernels,serving,train (build always runs)")
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
    from lmsu_tpu_torch.inference import pin_f32_precision
    pin_f32_precision()
    dev = torch.device("cuda", 0)

    secs = build_all()
    log(f"[build] {len(kernels())} kernels in {secs:.2f} s")
    for k in kernels().values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {k.name}: {line.strip()}")

    phases = set(args.phases.split(","))
    kres = phase_kernels(dev) if "kernels" in phases else {}
    sres, tres = {}, {}
    if "serving" in phases:
        sres["f32"], sd = phase_serving(dev, torch.float32)
        sres["bf16"], _ = phase_serving(dev, torch.bfloat16, sd)
        sres["pallas_f32"], _ = phase_serving(dev, torch.float32, sd, "pallas", 16)
        with fwd_flat():
            sres["flat_f32"], _ = phase_serving(dev, torch.float32, sd, n_frames=16)
    if "train" in phases:
        t0 = time.perf_counter()
        tres["check"] = check_kernel_vs_plain_step(dev)
        log(f"[train] kernel path == plain path: {json.dumps(tres['check'])}")
        tres["f32"] = phase_train(dev, torch.float32)
        tres["bf16"] = phase_train(dev, torch.bfloat16)
        tres["cli"] = run_train_cli(dev)
        log(f"[train] train_distill CLI: {json.dumps(tres['cli'])}")
        tres["fused_check"] = check_fused_step(dev)
        log(f"[train] fused_train blocks and step == plain versions / unfused: "
            f"{json.dumps(tres['fused_check'])}")
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tres[f"fused_{dt}"] = phase_train(dev, dtype, variants=("in_loop",),
                                              fused_train=True)
        for dt in ("f32", "bf16"):
            for run, variant, need in ((dt, "in_loop", TRAIN_KERNELS),
                                       (dt, "cached", TRAIN_KERNELS),
                                       (f"fused_{dt}", "in_loop",
                                        TRAIN_KERNELS + IR_TRAIN_KERNELS)):
                n = tres[run][variant]["launches"]
                if any(n[k] <= 0 for k in need):
                    raise AssertionError(f"train {run} {variant}: a kernel was not launched: {n}")
        tres["pallas_check"] = check_kernel_vs_plain_step(dev, scatter="pallas")
        log(f"[train] kernel path (pallas scatter) == plain path: "
            f"{json.dumps(tres['pallas_check'])}")
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            run = tres[f"pallas_{dt}"] = phase_train(dev, dtype, variants=("in_loop",),
                                                     scatter="pallas")
            per_step = run["in_loop"]["launches_per_step"]
            # K6 in the student's and the teacher's encoder; never K1 or K5.
            if (per_step["voxelize_scatter_max"] != 2
                    or any(per_step[k] <= 0 for k in ("fusion_gate", "kd_feature_mse"))
                    or any(per_step[k] for k in ("scatter_sorted_fwd", "scatter_sorted_fwd_flat",
                                                 "scatter_sorted_bwd"))):
                raise AssertionError(f"train pallas {dt}: launches per step {per_step}")
        log(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # Each kernel's launches are counted on its slice's main path, f32: the
    # serving run for K1-K3, the 10 timed in-loop KD steps for K5, K7, the 10
    # timed in-loop KD steps with fused_train for K8-K13, the serving runs
    # with the pallas scatter (K6, with its KD run beside) and with
    # _FWD_FLAT (K4). The times in an entry are at that path's shape (kind,
    # C, batch; K8-K13 summed over the five stages at B=128, per stage under
    # "stages"); the other shapes the kernel was checked at follow under
    # "other_shapes", the skewed cloud under "skewed" (K1's from K4's runs;
    # K5's at B=128).
    meta = {
        "scatter_sorted_fwd": ("lmsu_tpu/ops/scatter_sorted_pallas.py:163",
                               ("scatter", 128, B), "serving"),
        "scatter_sorted_fwd_flat": ("lmsu_tpu/ops/scatter_sorted_pallas.py:211",
                                    ("scatter_flat", 128, B), "serving_flat"),
        "voxelize_scatter_max": ("lmsu_tpu/ops/voxelize_pallas.py:54", ("voxelize", 128, B),
                                 "serving_pallas"),
        "fusion_gate": ("lmsu_tpu/ops/fusion_pallas.py:41", ("gate", 128, B), "serving"),
        "ir_fused_infer": ("lmsu_tpu/ops/ir_fused.py:223", ("ir", 0, B), "serving"),
        "scatter_sorted_bwd": ("lmsu_tpu/ops/scatter_sorted_pallas.py:263",
                               ("scatter_bwd", 128, TRAIN_B), "train"),
        "kd_feature_mse": ("lmsu_tpu/ops/kd_loss_pallas.py:48", ("kd_mse", 256, TRAIN_B),
                           "train"),
    }
    for name, line in zip(IR_TRAIN_KERNELS, (362, 384, 414, 424, 462, 517)):
        meta[name] = (f"lmsu_tpu/ops/ir_fused.py:{line}", (name, 0, TRAIN_B), "fused_train")
    counted_on = {"serving": "f32 serving run",
                  "serving_flat": "f32 serving run with _FWD_FLAT",
                  "serving_pallas": "f32 serving run with scatter_impl=pallas",
                  "train": "f32 in-loop KD run at B=128, 10 timed steps",
                  "fused_train": "f32 in-loop KD run with fused_train at B=128, 10 timed steps"}

    def launches(path, dt, name):
        if path.startswith("serving"):
            run = {"serving": dt, "serving_flat": f"flat_{dt}",
                   "serving_pallas": f"pallas_{dt}"}[path]
            return sres.get(run, {}).get("launches", {}).get(name, 0)
        run = {"train": dt, "fused_train": f"fused_{dt}", "train_pallas": f"pallas_{dt}"}[path]
        return tres.get(run, {}).get("in_loop", {}).get("launches", {}).get(name, 0)

    lines = []
    for name, (replaces, (op, C, b), path) in meta.items():
        entry = {"name": name, "route": "cuda", "source": f"lmsu_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces, "launches": launches(path, "f32", name),
                 "launches_counted_on": counted_on[path]}
        if tres and path in ("serving", "serving_pallas"):
            train = "train_pallas" if path == "serving_pallas" else "train"
            entry["train_launches"] = launches(train, "f32", name)
            entry["train_launches_bf16"] = launches(train, "bf16", name)
        if kres:
            f32 = kres[(op, "f32", C, b)]
            bf16 = dict(kres[(op, "bf16", C, b)])
            # The K4 and K6 serving runs are f32 only.
            bf16["launches"] = None if path.startswith("serving_") else launches(path, "bf16",
                                                                                 name)
            entry.update({k: f32.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "eager_ms",
                                                  "shape")})
            for k in ("near_teacher", "bf16_products"):
                if k in f32:
                    entry[k] = f32[k]
            if "library" in f32:
                entry["library"] = f32["library"]
            entry["kernel_ms"] = f32["ms"]
            if "stages" in f32:
                entry["stages"] = f32["stages"]
            if path == "fused_train":
                entry["block_fwd_bwd_ms"] = {dt: kres[("ir_block", dt, 0, TRAIN_B)]
                                             for dt in ("f32", "bf16")}
            entry["other_shapes"] = [
                {"C": k[2], "B": k[3], "f32": v, "bf16": kres[(k[0], "bf16") + k[2:]]}
                for k, v in kres.items()
                if k[0] == op and k[1] == "f32" and k[2:] != (C, b)]
            if op in ("scatter", "scatter_flat", "voxelize", "scatter_bwd"):
                skew = "scatter_flat_skew" if op == "scatter" else op + "_skew"
                pick = ((lambda r: {"ms": r["k1_ms"], "shape": r["shape"]}) if op == "scatter"
                        else dict)
                entry["skewed"] = [{"C": k[2], "B": k[3], "f32": pick(v),
                                    "bf16": pick(kres[(k[0], "bf16") + k[2:]])}
                                   for k, v in kres.items() if k[0] == skew and k[1] == "f32"]
            entry["dtype"] = "float32"
            entry["bf16"] = bf16
        lines.append(entry)
    print(json.dumps({"kernels": lines}))
    if sres:
        print(json.dumps({"serving": {k: v["stats"] for k, v in sres.items()},
                          "card": smi}))
    if tres:
        summary = {dt: {v: {k: tres[dt][v][k] for k in ("step_ms", "frames_per_s")}
                        for v in ("in_loop", "cached")} for dt in ("f32", "bf16")}
        for dt in ("f32", "bf16"):
            for run, key in (("fused", "fused_train"), ("pallas", "pallas_scatter")):
                summary[f"{key}_{dt}"] = {"in_loop": {
                    k: tres[f"{run}_{dt}"]["in_loop"][k] for k in ("step_ms", "frames_per_s")}}
        print(json.dumps({"train": summary, "batch": TRAIN_B, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
