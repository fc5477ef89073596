#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py                 # everything (needs one GPU)
    python3 chip_smoke.py --phases kernels,train
    python3 chip_smoke.py --phases pandaset
    python3 chip_smoke.py --phases parallel
    python3 chip_smoke.py --phases experiments

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
             memory and resident blocks; K7 also at B=128 with Cs 256 and
             Ct 512 (the concat/256 student's post_fusion tap and its 2x
             teacher's, Ct at the kernel's limit), and at six other widths at B=2
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
             Then concat/256 (ModelConfig(num_classes=2)'s defaults, with
             the sorted scatter and fused_inference): 16 frames in f32
             with the same checks, K1 and K3 launched, K2 not; and one B=8
             f32 forward each of minimal/128, gated_sum/128 and minimal/128
             with the x4 head (256^2 logits), kernel path against plain
             path, K1 and K3 launched, K2 not. Then the rest of serving:
             Predictor(freeze_weights=True) against the same weights
             unfrozen (f32 within 1e-3, bf16 2e-2 of scale; K1-K3 launch;
             B=1 and B=8 forward device times of each; the engine refuses a
             swap); int8 (Predictor.quantize on 8 frames) of weighted/128
             and concat/256: at each quantised layer's (M, K, N) at B=8 the
             card's int8 product equals its exact plain version in int32,
             timed beside the layer's f32 1x1, int8 against float logits
             (tests/test_quant.py's bar), B=8 forward device time float,
             int8 and int8 frozen; five artifacts (Predictor.export at B=8:
             with and without point_valid, int8, K4, K6), each reloaded and
             held within 1e-5 of scale of the in-process frozen forward
             with equal argmax, its kernels counted by the wrappers and by
             torch.profiler, its size printed, the first served by a
             `python -m lmsu_tpu_torch.serve --artifact` child over HTTP;
             and the host cost of calling K1-K3 through their operators.
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
             fall, K6 twice per step, K1 and K5 never). Then the concat/256
             student with its 2x teacher: one B=8 f32 step, kernel path
             against plain path; and the in-loop B=128 step of concat/256
             and of minimal/128 in f32 and bf16 (loss must fall; K1, K5 and
             K7 must launch, K2 must not). Then one epoch of `python -m
             lmsu_tpu_torch.train_fusion_ablation` (concat, minimal and
             weighted at full width; each exact parameter count checked in
             its JSON) and of `python -m lmsu_tpu_torch.train_synthetic`
             (concat/256), whose latest.pth `python -m
             lmsu_tpu_torch.evaluate` must read back at the val mIoU the
             trainer recorded. Before those, the best KD recipe
             (best_overall_results.json: minimal/128, T=4, noisy-student
             augmentation without the flip, the dataset-wide teacher cache,
             the pallas scatter K6 and K7): apply_augment on the card against
             the CPU with the same draws (labels and masks exactly, image
             and points within 1e-6); one teacher epoch and one distill
             epoch of `python -m lmsu_tpu_torch.train_distill` with the
             recipe's flags on 400 + 64 hard synthetic samples (the cache on
             the device under 6 GiB, its size printed; K6 and K7 must
             launch); the same distill with the default 4 GiB limit, which
             must spill to host memory and gather the first batch's targets
             bit for bit as the device cache does (the spill's cost per step
             printed); the recipe's step at B=128 in f32 and bf16 with its
             cache on the device (K6 once and K7 three times a step; the
             device time of the augmentation and of the gather printed; loss
             must fall); a K=2 ensemble (its logits and taps the members'
             mean, one B=8 step; K=1 the single teacher bit for bit) and its
             in-loop B=128 f32 step. Then this slice's paths: both published
             KD recipes whole through `train_distill` with --scan-steps 13
             (the 13 batches of 400 samples at B=32 make one chunk), with and
             without --onchip-epoch: the best one (minimal/128) and the
             cross-architecture one (a weighted/128 PointPillars student,
             a spatial 2x teacher); K6 and K7 must launch in each; each
             phase's epoch seconds and input stall printed. The best recipe's
             distill epoch through each loop from the same weights
             (recipe_loops: host loop, 13-step chunk, on-device epoch,
             contiguous on-device epoch; seconds and the idle share of a
             profiled epoch each; deterministic cuDNN; each held to the host
             loop, in the on-device epoch's order for those, by hold_epoch: the same
             inputs at every step bit for bit, the first step's loss within
             1e-5, the epoch within 10x the host loop's spread);
             its spilled distill (now gathering a chunk's rows on the host).
             A train_distill child with --handle-sigterm gets SIGTERM in its
             first epoch, exits 0 after it, and --resume --async-checkpoint
             --snapshot-every 1 finishes the run (epoch_002.pth loads as a
             teacher); an async save equals a synchronous one bit for bit;
             debug_nans raises at a LiDAR module on a NaN intensity, on the
             kernel path. The pillar student at full width (528,324
             parameters) with its spatial teacher: the B=8 step against the
             plain path (hold_step + 10x the plain step's spread under 1e-7),
             the in-loop B=128 step in f32 and bf16 (K1, K2, K5, K7 launch;
             step ms, idle share, peak memory, device ms by kernel), one B=8
             serving forward with fused_inference (K1, K2, K3). Remat: the
             B=128 f32 in-loop step with CameraEncoderConfig.remat against
             the step without it, unfused and fused_train, deterministic
             cuDNN, hold_step's fixed limits; then both timed (5 steps each)
             with their peak memory.
  5. pandaset PandaSet-scale data (run_pandaset_cli): 224 frames of ~100,000
             points a sweep (4 under 5,000, so the pad path runs) and 256^2
             images made in numpy, decoded by data/pandaset.py::decode_frame
             (host ms a frame by the native route and by numpy); two frames
             with NaN coordinates whose labels must not change and whose NaN
             points must sort last; train/ and val/ packs; one epoch of
             `python -m lmsu_tpu_torch.train_pandaset` at full width
             (concat/256, 3 classes, batch 4) from the packs with the sorted
             scatter (K1 and K5 must launch; history, latest.pth, finite
             loss), then `python -m lmsu_tpu_torch.evaluate --num-classes 3
             --dataset packed` on its latest.pth (finite loss, the recorded
             val mIoU within 1e-3); K1, K5 (and K4 beside them) against their
             plain versions on a decoded batch with pad_points_are_valid=True (thousands of
             tied rows in each short cloud's centre cell; one cloud with NaN
             points), f32 and bf16. Where PIL and pandas are installed,
             `prepare_dataset --dataset pandaset` on a raw tree too.
  6. parallel data parallelism (phase_parallel): (a) the f32 in-loop KD
             step of weighted/128 at B=128 with its kernels and fused_train
             on a world-1 NCCL mesh (make_mesh) against the same step
             without one: no collective, the first step's loss and BN
             statistics bit for bit, its gradients within the plain step's
             own repeat (hold_step), device ms of both; (b) two ranks over
             gloo on the one card (parallel_rank, started by
             parallel/mesh.py::run_ranks after the build), B=64 each: first
             the fused blocks' glue, each of the student's five stages at
             B=128 in f32 and bf16, a rank's rows against the one-process
             block within fixed limits (GLUE_LIMITS), and each planted
             glue fault (a reduction left out) past them; then three steps
             of f32 and bf16 with fused_train on and off and of f32 with
             the fsdp teacher, against the one-process B=128 steps (f32:
             hold_step and the later losses within 10x a 1e-6
             perturbation's spread; bf16: within twice the one-process bf16
             step's distance from f32), and, recorded only, a run with K11's
             r2 sums left local; the ranks' parameters equal bit for bit,
             the collectives a step and their share of host time, the fsdp
             teacher's bytes a rank;
             (e) the model axis (parallel_model_axis_e): two gloo ranks on the
             card as a (data 1, model 2) mesh, weighted/128 and its 2x
             teacher at full width on the same path, B=128 a rank when two
             one-process peaks fit (else 64): the teacher split by channel
             (tp) and by image rows (sp), f32 and bf16, its logits and taps
             against the one-process teacher on the same rows (f32 1e-5 of
             scale; bf16 twice the one-process bf16 teacher's gap to f32),
             a fused_inference teacher split both ways (K3), each planted
             fault (`planted_split_fault`: a contraction fed a channel slice
             with no gather; a halo of zeros) at least 100x past the f32
             limit; three KD steps of
             each held as (b) holds its runs, the ranks' sha256 equal, the
             teacher's bytes and peak forward bytes a rank, the collectives
             a step by axis; (f) (while (d) runs) four gloo ranks as a
             (data 2, model 2) mesh, one tp and one sp KD step at the global
             B=16 against one process;
             (c) ServingEngine.from_predictor(devices=[the card]) against
             the plain engine bit for bit, and a `serve --data-parallel 1`
             child answering over HTTP; (d) `python -m
             lmsu_tpu_torch.run_multiprocess --device cuda --num-processes
             2`. The path's kernels must launch in each.
  7. experiments the KD experiments and the host tools
             (phase_experiments), every output under a temporary output
             root: (a) each of the eight experiments (`python -m
             lmsu_tpu_torch.experiments.<name>`: kd_lift, kd_sweep,
             kd_cache_equiv, kd_compression, kd_crossarch, best_overall,
             crossarch_best, kd_ensemble) through its main(argv) at a tiny
             regime (seed 0, one epoch, 64 train and 32 val hard synthetic
             samples, B=32, full width) with its kernel opt-ins (K1, K2,
             K5, K7; the recipe experiments K6, K7, and K2 for
             crossarch_best): the result JSON has the experiment's keys,
             every mIoU is finite and in [0, 1], each selected kernel
             launched; (b)
             `analyze_weighted_gate` on kd_lift's weighted/128 student with
             K2, then each gate variant K2 path against plain path within
             1e-3, uniform's camera weight exactly 0.5 and K2's fused map
             0.5 (cam + lid), camera_only's weight >= 1 - 1e-6 and its map
             the camera's, lidar_only's the LiDAR's (1e-5 of scale); (c)
             `visualize_predictions`' compute part on the card against the
             CPU: argmax equal where the CPU's margin exceeds 1e-3, IoUs
             equal where the argmax is; (d) utils/profiling.py's
             profiler_trace around two B=128 KD steps, K1's, K2's, K5's and
             K7's device functions in its Chrome trace; (e) StepTimer with
             the card around ten B=128 f32 KD steps, p50 within 10% of CUDA
             events' median (the unsynchronised timer's reading printed).

Output: the card's name and power limit (nvidia-smi), then per-phase lines,
the whole run's seconds, then one `{"kernels": [...]}` JSON line, the serving, train,
parallel and experiments summaries,
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


def scatter_bwd_bound(feats, keys, hw):
    """K5's bound: the valid rows of feats, the keys, out and g of the
    non-empty cells, all of d; two compares per valid element."""
    Bn, n, C = feats.shape
    k_np = keys.cpu().numpy()
    n_valid = int((k_np < hw).sum())
    n_cells = sum(len(np.unique(r[r < hw])) for r in k_np)
    es = feats.element_size()
    nbytes = n_valid * C * es + keys.numel() * 4 + 2 * n_cells * C * es + Bn * n * C * es
    return bound_ms(nbytes, 2 * n_valid * C, feats.dtype)


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
    n_cells = sum(len(np.unique(r[r < hw])) for r in keys.cpu().numpy())
    bound, by = scatter_bwd_bound(feats, keys, hw)
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
    rng_kd512 = np.random.default_rng(1024)  # K7 at Ct 512, a stream of its own
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        runs = [("scatter", C, b, kernel_scatter) for b in (B, TRAIN_B) for C in (128, 256)]
        runs += [("scatter_bwd", 128, b, kernel_scatter_bwd) for b in (B, TRAIN_B)]
        runs += [("kd_mse", 256, b, kernel_kd_mse) for b in (B, TRAIN_B)]
        # K7 at the concat/256 student's post_fusion tap: Cs 256 against its
        # 2x teacher's Ct 512, the widest Ct the kernel takes.
        runs.append(("kd_mse", 512, TRAIN_B, kernel_kd_mse))
        # K2 also at C=512 (a 4x teacher; inputs from a stream of its own).
        runs += [("gate", 128, B, kernel_gate), ("gate", 128, TRAIN_B, kernel_gate),
                 ("gate", 256, TRAIN_B, kernel_gate), ("gate", 512, B, kernel_gate)]
        for kind, fn in (("voxelize", kernel_unsorted), ("scatter_flat", kernel_flat)):
            runs += [(kind + tag, C, b, fn) for tag in ("", "_skew")
                     for b, C in ((B, 128), (TRAIN_B, 128), (TRAIN_B, 256))]
        runs.append(("scatter_bwd_skew", 128, TRAIN_B, kernel_scatter_bwd))
        for kind, C, b, fn in runs:
            kw = {"C": C, "B": b}
            if kind == "kd_mse":
                kw = {"B": b, "cs": C // 2, "ct": C}
            if kind.endswith("_skew"):
                kw["skew"] = True
            src = (rng_k4_k6 if fn in (kernel_unsorted, kernel_flat)
                   else rng_k5_skew if kind == "scatter_bwd_skew"
                   else rng_kd512 if kind == "kd_mse" and C == 512
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


# The models this script drives: (fusion_type, fusion_out_channels,
# output_mode). "weighted" is the weighted/128 student; "concat" is
# ModelConfig(num_classes=2)'s own defaults, concat/256.
MODELS = {"weighted": ("weighted", 128, "same"), "concat": ("concat", 256, "same"),
          "minimal": ("minimal", 128, "same"), "gated_sum": ("gated_sum", 128, "same"),
          "minimal_x4": ("minimal", 128, "x4"), "weighted_pillars": ("weighted", 128, "same")}
# The LiDAR encoder of each model (spatial unless named here): the
# cross-architecture recipe's student, whose teacher stays spatial.
ENCODERS = {"weighted_pillars": "pointpillars"}


def lidar_config(model, scatter):
    from lmsu_tpu_torch.config import LidarEncoderConfig
    return LidarEncoderConfig(scatter_impl=scatter,
                              encoder_type=ENCODERS.get(model, "spatial"))


def serving_config(dtype, kernels=True, scatter="sorted_pallas", model="weighted"):
    """`model` at full width with the kernel opt-ins (the scatter `scatter`,
    fused_inference, and the fused gate where the fusion is weighted, the
    only one that has it) or without them (the xla scatter)."""
    from lmsu_tpu_torch.config import CameraEncoderConfig, ModelConfig
    fusion, channels, head = MODELS[model]
    return ModelConfig(
        num_classes=2, fusion_type=fusion, fusion_out_channels=channels, output_mode=head,
        use_pallas_fusion=kernels and fusion == "weighted",
        camera=CameraEncoderConfig(fused_inference=kernels),
        lidar=lidar_config(model, scatter if kernels else "xla"),
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


# The forward kernels by their device function names, for torch.profiler.
PROFILED = {"scatter_sorted_fwd": "scatter_sorted_fwd_kernel",
            "scatter_sorted_fwd_flat": "flat_walk_kernel",
            "voxelize_scatter_max": "voxelize_scatter_max_kernel",
            "fusion_gate": "fusion_gate_kernel", "ir_fused_infer": "ir_infer_kernel"}


def profile_call(fn, reps: int = 5) -> dict:
    """Where one call of fn's time goes: host wall ms to a synchronised
    result (median), device ms (the sum over its device-side events under
    torch.profiler: kernels and copies, a mean over `reps` calls), the
    kernels with the most of it, and the launches a call of each kernel in
    PROFILED."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
                   for e in dev), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    seen = {k: sum(e.count for e in dev if name in e.key) / reps for k, name in PROFILED.items()}
    return {"wall_ms_median": float(np.median(walls)), "device_ms": device_ms,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:12]],
            "kernels_a_call": seen}


def profile_forward(pred, frames, prepped, reps: int = 5):
    """Where one B=8 forward's time goes (profile_call)."""
    imgs = np.stack([f[0] for f in frames])
    pts = np.stack([p for p, _ in prepped])
    pv = np.stack([v for _, v in prepped])
    return profile_call(lambda: pred.forward_batch(imgs, pts, pv), reps)


def check_model_forward(dev, model):
    """One B=8 f32 forward of `model` at full width, seeded weights and
    randomised BatchNorms, on the kernel path (sorted scatter K1, fused
    blocks K3; the points cell-sorted by the Predictor) against the same
    weights on the plain path (the xla scatter on the points in another
    order, unfused blocks): within 1e-3, as the serving check (b). K1 and K3
    must launch in the kernel path's forward; K2 (the weighted fusion's
    gate) must launch for a weighted model and must not for the others."""
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    pred = Predictor(serving_config(torch.float32, model=model), device=dev, seed=0)
    randomize_bn(pred.model, 1)
    plain = Predictor(serving_config(torch.float32, kernels=False, model=model),
                      pred.model.state_dict(), device=dev)
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    pts = make_points(rng, NPTS, B)
    pv = rng.uniform(size=(B, NPTS)) > 0.1
    reset_launch_counts()
    a = pred(imgs, pts, pv).float().cpu().numpy()
    launches = {k: v.launches for k, v in kernels().items()}
    perm = rng.permutation(NPTS)
    b = plain.forward_batch(imgs, pts[:, perm], pv[:, perm]).float().cpu().numpy()
    up = 4 if MODELS[model][2] == "x4" else 1
    err = float(np.abs(a - b).max())
    if a.shape != (B, GRID * up, GRID * up, 2) or not np.isfinite(a).all() or err > 1e-3:
        raise AssertionError(f"{model}: kernel path != plain path: shape {a.shape}, {err:g}")
    gate = MODELS[model][0] == "weighted"
    if (any(launches[k] <= 0 for k in ("scatter_sorted_fwd", "ir_fused_infer"))
            or bool(launches["fusion_gate"]) != gate):
        raise AssertionError(f"{model}: launches in the forward: {launches}")
    return {"err_kernels_vs_plain_path": err, "logits_shape": list(a.shape),
            "launches": {k: n for k, n in launches.items() if n}}


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


def phase_serving(dev, dtype, state_dict=None, scatter="sorted_pallas", n_frames=32,
                  model="weighted"):
    """With scatter="sorted_pallas" K1 (K4 under fwd_flat) serves the
    scatter, with "pallas" K6; of the three scatter kernels only that one
    may launch, and with "pallas" no host sort runs. K2 launches for the
    weighted fusion and for no other."""
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.serving import ServingEngine, make_server
    name = "f32" if dtype == torch.float32 else "bf16"
    scatter_kernel = ("voxelize_scatter_max" if scatter == "pallas" else
                      "scatter_sorted_fwd_flat" if ss._FWD_FLAT else "scatter_sorted_fwd")
    if scatter_kernel != "scatter_sorted_fwd":
        name = f"{name} {scatter_kernel}"
    if model != "weighted":
        name = f"{model} {name}"
    pred = Predictor(serving_config(dtype, scatter=scatter, model=model), state_dict,
                     device=dev, seed=0)
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
        need = ["ir_fused_infer", scatter_kernel]
        not_run = [k for k in SCATTER_KERNELS if k != scatter_kernel]
        (need if model == "weighted" else not_run).append("fusion_gate")
        if any(launches[k] <= 0 for k in need) or any(launches[k] for k in not_run):
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
            plain = Predictor(serving_config(dtype, kernels=False, model=model),
                              pred.model.state_dict(), device=dev)
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


# -- the rest of serving: frozen weights, int8, artifacts ----------------------

def serving_batch(seed: int):
    """B=8 serving inputs: uint8 images, NPTS points with boundary cases, a
    point_valid mask (1 in 10 invalid)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    return imgs, make_points(rng, NPTS, B), rng.uniform(size=(B, NPTS)) > 0.1


def rel_err(a, b) -> float:
    a, b = (t.float().cpu().numpy() if hasattr(t, "cpu") else t for t in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_frozen(dev, dtype, sd) -> dict:
    """Predictor(freeze_weights=True) of the weighted/128 serving model at
    full width against the same weights unfrozen, on one B=8 batch: f32
    within 1e-3 (the serving bar); bf16 within twice the unfrozen bf16
    model's own gap to f32 on the same batch (folding BN into a bf16 weight
    rounds at other places than BN after a bf16 conv); K1, K2 and K3 launch
    in the frozen forward; B=1 and B=8 forward device times, frozen and not;
    the engine refuses a swap."""
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.serving import ServingEngine
    cfg = serving_config(dtype)
    live = Predictor(cfg, sd, device=dev)
    frozen = Predictor(cfg, sd, device=dev, freeze_weights=True)
    imgs, pts, pv = serving_batch(21)
    pts, pv = live._maybe_sort(pts, pv)
    a = live.forward_batch(imgs, pts, pv)
    reset_launch_counts()
    b = frozen.forward_batch(imgs, pts, pv)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels().items() if v.launches}
    if any(launches.get(k, 0) <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"frozen forward launches {launches}")
    err = float((a.float() - b.float()).abs().max())
    scale = float(a.float().abs().max())
    gaps = {}
    if dtype == torch.float32:
        tol = 1e-3
    else:
        f32 = Predictor(serving_config(torch.float32), sd, device=dev).forward_batch(imgs, pts, pv)
        gaps = {k: float((v.float() - f32).abs().max()) for k, v in (("unfrozen", a),
                                                                      ("frozen", b))}
        tol = 2 * gaps["unfrozen"]
    if not (torch.isfinite(b.float()).all() and err <= tol):
        raise AssertionError(f"frozen != unfrozen [{dtype}]: {err:g} > {tol:g} "
                             f"(scale {scale:g})")
    times = {}
    for bsz in (1, B):
        args = [torch.from_numpy(x[:bsz]).to(dev) for x in (imgs, pts, pv)]
        for name, pred in (("unfrozen", live), ("frozen", frozen)):
            times[f"{name}_b{bsz}"] = profile_call(lambda: pred.forward_batch(*args))
    eng = ServingEngine.from_predictor(frozen, batch_size=B, image_size=(IMG, IMG),
                                       num_points=NPTS)
    try:
        eng.swap_variables(live.model.state_dict())
        raise AssertionError("a frozen engine took a weight swap")
    except RuntimeError as e:
        if "baked" not in str(e):
            raise
    finally:
        eng.close()
    return {"err_frozen_vs_unfrozen": err, "limit": tol, "scale": scale, "gap_to_f32": gaps,
            "launches": launches,
            "forward": times, "swap_refused": True}


def check_int8(dev, model="weighted", sd=None) -> dict:
    """Predictor.quantize of `model` at full width (f32) calibrated on 8
    synthetic frames. At each quantised layer's (M, K, N) at B=8 (taken from
    the int8 forward itself): the card's int8 product (torch._int_mm) equals
    its exact plain version (float64 of the int8 operands) in int32 bit for
    bit; its time beside the same layer's float 1x1 (an f32 matmul of the
    layer's input). Quantised logits against float on other frames:
    tests/test_quant.py's bar (within 0.15 of scale, > 97% argmax agreement
    where the float margin exceeds 0.1 of scale); the frozen int8 forward
    within 2e-2 of scale of it. B=8 forward device time, float, int8, and
    int8 frozen."""
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.models.layers import quant_stats
    from lmsu_tpu_torch.ops import quant
    pred = Predictor(serving_config(torch.float32, model=model), sd, device=dev, seed=0)
    if sd is None:
        randomize_bn(pred.model, 1)
    calib = serving_batch(31)
    imgs, pts, pv = serving_batch(32)
    pts, pv = pred._maybe_sort(pts, pv)
    args = [torch.from_numpy(x).to(dev) for x in (imgs, pts, pv)]
    flt = pred.forward_batch(*args)
    t_float = profile_call(lambda: pred.forward_batch(*args))
    pred.quantize([calib])
    names = sorted(quant_stats(pred.model))
    seen = []
    real = quant.int8_pointwise_q

    def tap(x, absmax, wq_t, w_scale, bias, out_dtype):
        seen.append((x.reshape(-1, x.shape[-1]), absmax, wq_t))
        return real(x, absmax, wq_t, w_scale, bias, out_dtype)
    quant.int8_pointwise_q = tap
    try:
        q = pred.forward_batch(*args)
    finally:
        quant.int8_pointwise_q = real
    if len(seen) != len(names):
        raise AssertionError(f"{model}: {len(seen)} int8 layers ran, {len(names)} calibrated")
    layers = []
    for x, absmax, wq_t in seen:
        xq, _ = quant.quantize_acts(x, absmax)
        got = quant.int8_matmul(xq, wq_t)
        want = quant.int8_matmul_plain(xq, wq_t.t())
        diff = int((got != want).sum())
        if got.dtype != torch.int32 or diff:
            raise AssertionError(f"{model}: int8 product != exact product at {tuple(x.shape)}: "
                                 f"{diff} differ")
        M, K = xq.shape
        N = wq_t.shape[0]
        xf, wf = x.float().contiguous(), wq_t.t().float().contiguous()
        layers.append({"M": M, "K": K, "N": N, "int8_ms": time_ms(lambda: quant.int8_matmul(
            xq, wq_t)), "float_1x1_ms": time_ms(lambda: xf @ wf)})
    t_int8 = profile_call(lambda: pred.forward_batch(*args))
    frozen = Predictor(pred.config, pred.model.state_dict(), device=dev, freeze_weights=True)
    frozen.quantize([calib])
    qf = frozen.forward_batch(*args)
    t_int8_frozen = profile_call(lambda: frozen.forward_batch(*args))
    a, b = q.float().cpu().numpy(), flt.float().cpu().numpy()
    scale = float(np.abs(b).max())
    decisive = np.abs(b[..., 1] - b[..., 0]) > 0.1 * scale
    agree = float((a.argmax(-1) == b.argmax(-1))[decisive].mean()) if decisive.any() else None
    err = float(np.abs(a - b).max()) / scale
    # The frozen copy folds BN into the float convs, so the int8 layers see
    # inputs that differ by f32 rounding, and an input on a rounding edge
    # moves its int8 value by one step: the serving bf16 bar, 2e-2 of scale.
    if (not np.isfinite(a).all() or err >= 0.15 or agree is None or agree <= 0.97
            or rel_err(qf, q) > 2e-2):
        raise AssertionError(f"{model} int8: {err:g} of scale, agreement {agree}, "
                             f"frozen int8 vs int8 {rel_err(qf, q):g}")
    return {"model": model, "quantised_layers": len(names), "layers": layers,
            "err_int8_vs_float_of_scale": err, "argmax_agreement_decisive": agree,
            "decisive_share": float(decisive.mean()), "err_frozen_int8_vs_int8": rel_err(qf, q),
            "forward_b8": {"float": t_float, "int8": t_int8, "int8_frozen": t_int8_frozen}}


def start_artifact_child(path: str, dev):
    """Starts `python -m lmsu_tpu_torch.serve --artifact path` in a child
    process (B=8, port 0); finish_artifact_child talks to it. Returns (the
    process, its start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-u", "-m", "lmsu_tpu_torch.serve", "--artifact", path,
           "--device", torch.device(dev).type, "--batch-size", str(B), "--port", "0",
           "--image-size", str(IMG), str(IMG), "--num-points", str(NPTS), "--max-delay-ms", "5"]
    return (subprocess.Popen(cmd, cwd=root, env=dict(os.environ, PYTHONUNBUFFERED="1"),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def finish_artifact_child(proc, t0, frames, want, what="serve --artifact") -> dict:
    """Waits for the child's "Serving on" line, posts `frames` over HTTP
    (npz), holds each response to `want` within 1e-4 of scale, reads GET
    /v1/stats, then stops it with SIGINT (its final stats printed); kills
    it on any failure. `what` names the child in errors."""
    import re
    import signal
    out = []
    try:
        url = None
        for line in proc.stdout:
            out.append(line.rstrip())
            m = re.search(r"Serving on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        if url is None:
            raise AssertionError(f"{what} did not start: {out[-10:]}")
        ready = time.perf_counter() - t0
        errs = []
        for (img, pts), w in zip(frames, want):
            buf = io.BytesIO()
            np.savez(buf, image=img, points=pts)
            req = urllib.request.Request(f"{url}/v1/predict", data=buf.getvalue(),
                                         headers={"Content-Type": "application/x-npz"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got = np.load(io.BytesIO(r.read()))["logits"]
            errs.append(float(np.abs(got - w).max() / np.abs(w).max()))
        with urllib.request.urlopen(f"{url}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        if max(errs) > 1e-4 or stats["requests"] != len(frames):
            raise AssertionError(f"{what}: errors {errs}, stats {stats}")
        proc.send_signal(signal.SIGINT)
        tail = proc.communicate(timeout=60)[0]
        out.extend(tail.splitlines())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: {out[-10:]}")
    return {"startup_s": ready, "max_err_of_scale": max(errs), "stats": stats,
            "final": [ln for ln in out if ln.startswith("Final stats")]}


def check_export(dev, sd, d) -> dict:
    """Predictor.export of the weighted/128 serving model at B=8 (f32):
    with and without point_valid, int8, and with K4 (_FWD_FLAT) or K6
    (scatter_impl="pallas") in place of K1. Each artifact, reloaded by
    load_exported, gives the in-process forward of the frozen Predictor
    within 1e-5 of scale with equal argmax, launches its kernels (counted by
    the wrappers in one call and by torch.profiler in a window of five, a
    window short of them taken again at most twice), and its size is
    printed; its B=8 forward and the in-process one are profiled on the same
    device tensors; the first is served by a `serve --artifact` child over
    HTTP."""
    out, child = {}, None
    try:
        for name, scatter, flat, pv_in, int8 in (
                ("point_valid", "sorted_pallas", False, True, False),
                ("no_point_valid", "sorted_pallas", False, False, False),
                ("int8", "sorted_pallas", False, True, True),
                ("flat_k4", "sorted_pallas", True, True, False),
                ("pallas_k6", "pallas", False, True, False)):
            child = export_one(dev, sd, d, out, name, scatter, flat, pv_in, int8) or child
        out["served"] = finish_artifact_child(*child)
    finally:
        if child is not None and child[0].poll() is None:
            child[0].kill()
            child[0].wait()
    return out


def export_one(dev, sd, d, out, name, scatter, flat, pv_in, int8):
    """One artifact of check_export, its results under out[name]. For the
    first, starts the `serve --artifact` child (it starts up while the rest
    run) and returns (process, start time, frames, expected logits)."""
    from lmsu_tpu_torch.inference import Predictor, load_exported
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    child = None
    with fwd_flat(flat):
        cfg = serving_config(torch.float32, scatter=scatter)
        pred = Predictor(cfg, sd, device=dev, freeze_weights=True)
        if int8:
            pred.quantize([serving_batch(31)])
        path = os.path.join(d, f"{name}.pt2")
        t0 = time.perf_counter()
        pred.export(path, batch_size=B, image_size=(IMG, IMG), num_points=NPTS,
                    with_point_valid=pv_in)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = load_exported(path)
        load_s = time.perf_counter() - t0
        imgs, pts, pv = serving_batch(41)
        pts, pv = pred._maybe_sort(pts, pv if pv_in else None)
        fimgs = imgs.astype(np.float32) / 255.0
        args = [None if x is None else torch.from_numpy(x).to(dev) for x in (fimgs, pts, pv)]
        want = pred.forward_batch(*args)
        fn(*args)  # first call: K3's fragments of the loaded weights
        torch.cuda.synchronize()
        reset_launch_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in kernels().items() if v.launches}
        scatter_kernel = ("voxelize_scatter_max" if scatter == "pallas" else
                          "scatter_sorted_fwd_flat" if flat else "scatter_sorted_fwd")
        need = {scatter_kernel: 1, "fusion_gate": 1, "ir_fused_infer": 5}
        # Now and then CUPTI drops a few device records of a window, of any
        # kernel: its host side holds every launch, its device side a few
        # fewer. A window short of `need` is taken again, at most twice; the
        # wrappers' count above is exact and taken once.
        for windows in range(1, 4):
            prof = profile_call(lambda: fn(*args))
            if all(prof["kernels_a_call"][k] >= n for k, n in need.items()):
                break
        prof["windows"] = windows
        in_process = profile_call(lambda: pred.forward_batch(*args))
    err = rel_err(got, want)
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    if (err > 1e-5 or not same or launches != need
            or any(prof["kernels_a_call"][k] < n for k, n in need.items())):
        raise AssertionError(f"artifact {name}: err {err:g}, argmax equal {same}, "
                             f"launches {launches}, profiled {prof['kernels_a_call']}")
    out[name] = {"err_vs_in_process_of_scale": err, "launches": launches,
                 "size_mb": os.path.getsize(path) / 1e6, "export_s": export_s,
                 "load_s": load_s, "forward": prof, "in_process_forward": in_process,
                 "err_vs_unfrozen_of_scale": rel_err(got, Predictor(
                     cfg, sd, device=dev).forward_batch(*args))}
    if name == "point_valid":
        frames = [(imgs[i], make_points(np.random.default_rng(50 + i), NPTS, 1)[0])
                  for i in range(4)]
        expect = [pred(imgs[i:i + 1].astype(np.float32) / 255.0, p[None],
                       np.ones((1, NPTS), bool)).float().cpu().numpy()[0]
                  for i, (_, p) in enumerate(frames)]
        child = (*start_artifact_child(path, dev), frames, expect)
    log(f"[serving export {name}] {json.dumps(out[name])}")
    return child


def host_us(fn, calls: int = 200, rounds: int = 7) -> float:
    """Host microseconds to enqueue one call of fn (no synchronisation
    inside a round of `calls`; the device queue absorbs them), the median
    over `rounds`."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(samples))


def op_wrapper_cost(dev) -> dict:
    """Host cost of calling K1, K2 and K3 through their operators
    (ops/_cuda.py::define_op) against calling their launch functions
    directly, at the serving shapes (f32, B=8): host microseconds to enqueue
    a call of each (host_us, in turns: operator, direct, direct, operator),
    and the difference."""
    from lmsu_tpu_torch.ops import fusion_gate as fg
    from lmsu_tpu_torch.ops import ir_fused as irf
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    rng = np.random.default_rng(61)
    feats, keys = sorted_inputs(rng, 128, torch.float32, dev)[:2]
    cam = torch.randn(B, GRID, GRID, 128, device=dev)
    lid = torch.randn(B, GRID, GRID, 128, device=dev)
    gate = (torch.randn(128, 256, 1, 1, device=dev) * 0.05, torch.zeros(128, device=dev),
            torch.randn(2, 128, 1, 1, device=dev) * 0.05, torch.zeros(2, device=dev))
    x = torch.randn(B, 32, 32, 128, device=dev)
    p = random_ir_params(rng, dev, 128, 128, 6)
    calls = {"scatter_sorted_fwd": (lambda: ss.segment_max(feats, keys, GRID * GRID),
                                    lambda: ss._segment_max_cuda(feats, keys, GRID * GRID)),
             "fusion_gate": (lambda: fg.fusion_gate_fwd(cam, lid, *gate),
                             lambda: fg._fusion_gate_cuda(cam, lid, *gate)),
             "ir_fused_infer": (lambda: irf.fused_ir_infer(x, p, 1),
                                lambda: irf._fused_ir_infer_cuda(x, *p, 1))}
    out = {}
    for name, (op, direct) in calls.items():
        a1, b1, b2, a2 = host_us(op), host_us(direct), host_us(direct), host_us(op)
        a, b = (a1 + a2) / 2, (b1 + b2) / 2
        out[name] = {"op_host_us": a, "direct_host_us": b, "op_cost_us": a - b}
    return out


# -- train phase -------------------------------------------------------------


def train_config(dtype, kernels=True, batch=TRAIN_B, save_dir=None, fused_train=False,
                 scatter="sorted_pallas", model="weighted", augment=None, kd=None,
                 remat=False):
    """The KD student step of bench.py: the student `model` (MODELS; the
    weighted/128 student unless said), its 2x teacher, AdamW lr 1e-3
    (constant: eta_min = lr) and wd 1e-3, class weights (0.4, 3.5), the
    three default taps; kernels on (with the scatter `scatter`, and the
    fused gate where the fusion is weighted) or off; the student's
    InvertedResidual stages fused in training (K8-K13) or not, and
    rematerialised (`remat`) or not; `augment` an AugmentConfig, `kd` more
    KDConfig fields (the recipe's temperature, the cache, an ensemble). The
    teacher is teacher_for(config)."""
    from lmsu_tpu_torch.config import (AugmentConfig, CameraEncoderConfig, DataConfig,
                                       ExperimentConfig, KDConfig, ModelConfig, TrainConfig)
    fusion, channels, head = MODELS[model]
    student = ModelConfig(num_classes=2, fusion_type=fusion, fusion_out_channels=channels,
                          output_mode=head, use_pallas_fusion=kernels and fusion == "weighted",
                          camera=CameraEncoderConfig(fused_train=fused_train, remat=remat),
                          lidar=lidar_config(model, scatter if kernels else "xla"),
                          compute_dtype=dtype)
    train = TrainConfig(lr=1e-3, eta_min=1e-3, weight_decay=1e-3, class_weights=(0.4, 3.5),
                        kd=KDConfig(enabled=True, use_pallas=kernels, **(kd or {})),
                        augment=augment or AugmentConfig(),
                        save_dir=save_dir or os.path.join("build", "train_smoke"))
    return ExperimentConfig(model=student, data=DataConfig(batch_size=batch), train=train)


def teacher_for(cfg):
    """The 2x teacher of a train_config: teacher_config of the student, with
    the spatial LiDAR encoder (a pillar student's teacher is spatial, as in
    the cross-architecture recipe; for the others this changes nothing)."""
    import dataclasses

    from lmsu_tpu_torch.config import teacher_config
    t = teacher_config(cfg.model, 2.0)
    return t.replace(lidar=dataclasses.replace(t.lidar, encoder_type="spatial"))


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
    tr = DistillationTrainer(cfg, [batch], [batch], device=dev,
                             teacher_model_config=teacher_for(cfg))
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


def check_kernel_vs_plain_step(dev, scatter="sorted_pallas", model="weighted",
                               perturb: float = 0.0):
    """One f32 KD step of the student `model` at B=8, TF32 off: the kernel
    path (sorted scatter K1+K5, or with scatter="pallas" the unsorted
    scatter K6 with the dense backward; fused gate K2 for the weighted
    fusion; fused feature MSE K7) against the plain path
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
    checks differ by the scatter alone. With `perturb`, each limit also
    gains ten times the plain step's own spread under that perturbation of
    the weights (hold_step's `noise`, as check_fused_step holds the fused
    step): the pillar student's step, whose camera-encoder gradients (convs
    that a train-mode BatchNorm follows: sums that cancel) read 1.6e-3
    relative L2 from the plain path's, over the fixed 1e-3, in a first
    call on the card."""
    rng = np.random.default_rng(11)
    batch = train_batch(rng, B, dev)
    plain = train_config(torch.float32, False, B, model=model)
    return hold_step(f"KD step of {model}, kernel path ({scatter}) vs plain path",
                     kd_step(dev, batch, train_config(torch.float32, True, B, scatter=scatter,
                                                      model=model)),
                     kd_step(dev, batch, plain),
                     noise=kd_step(dev, batch, plain, perturb=perturb) if perturb else None)


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


def profile_steps(step, reps: int = 2, spans=()):
    """Device time by kernel over `reps` steps (torch.profiler) and the
    share of the steps' wall time the device was idle; for each
    record_function range named in `spans`, the device time of the kernels
    launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    averages = prof.key_averages()
    # A range's own device-side annotation is not a kernel: left out.
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
            for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in spans]
    span_ms = {name: sum(e.device_time_total for e in averages
                         if e.key == name and e.device_type == DeviceType.CPU) / reps / 1e3
               for name in spans}
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
            "spans_device_ms": span_ms,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:15]]}


class OneBatchLoader:
    """A training loader of one fixed batch over a dataset of its rows, for
    DistillationTrainer.build_teacher_cache."""

    def __init__(self, batch):
        self.batch = batch
        self.batcher = argparse.Namespace(dataset=range(len(batch["sample_index"])))

    def __len__(self):
        return 1

    def __iter__(self):
        yield self.batch


def spanned(name, fn):
    """`fn` inside a torch.profiler.record_function range `name`."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


SPANS = ("augment", "teacher_cache_gather")


def phase_train(dev, dtype, warmup: int = 3, steps: int = 10, variants=("in_loop", "cached"),
                fused_train=False, scatter="sorted_pallas", model="weighted", augment=None,
                kd=None, remat=False):
    """The KD step at B=128 through DistillationTrainer.train_step on one
    fixed batch: in-loop teacher, then cached teacher (its outputs computed
    once for the batch, bench.py:233-244); "dataset_cache", the trainer's
    own teacher cache (build_teacher_cache over a loader of this batch,
    each step gathering its rows on the device); with fused_train, the
    student's InvertedResidual stages run K8-K13; with scatter="pallas" the
    scatter is K6 on points in their own order; `model` the student
    (MODELS); `augment` and `kd` as train_config's. Launches of each kernel
    per step are counted over the timed steps; the loss must fall over
    them. The augmentation and the cache gather run inside profiler ranges
    (SPANS), whose device time the profile reports."""
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.training import DistillationTrainer
    name = "f32" if dtype == torch.float32 else "bf16"
    kd = dict(kd or {})
    tag = " ".join(([model] if model != "weighted" else []) + [name]
                   + (["fused_train"] if fused_train else []) + (["remat"] if remat else [])
                   + ([scatter] if scatter != "sorted_pallas" else [])
                   + (["augment"] if augment else [])
                   + ([f"ensemble {kd['ensemble_size']}"] if "ensemble_size" in kd else []))
    rng = np.random.default_rng(5)
    batch = train_batch(rng, TRAIN_B, dev, sort=scatter == "sorted_pallas")
    batch["sample_index"] = torch.arange(TRAIN_B, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if "dataset_cache" in variants:
        kd["cache_teacher"] = True
    loader = OneBatchLoader(batch) if "dataset_cache" in variants else [batch]
    cfg = train_config(dtype, fused_train=fused_train, scatter=scatter, model=model,
                       augment=augment, kd=kd, remat=remat)
    tr = DistillationTrainer(cfg, loader, [batch], device=dev,
                             teacher_model_config=teacher_for(cfg))
    tr._augmented = spanned("augment", tr._augmented)
    tr.gather_teacher = spanned("teacher_cache_gather", tr.gather_teacher)
    out = {}
    for variant in variants:
        if variant == "dataset_cache":
            tr.build_teacher_cache()
            if tr.teacher_cache is None:
                raise AssertionError(f"train {tag}: the teacher cache is not on the device")
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
                        "profile": profile_steps(step, spans=SPANS)}
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


ABLATION_PARAMS = {"concat": "573,442", "minimal": "494,978", "weighted": "528,132"}


def run_ablation_cli(dev):
    """The fusion-ablation entry point on the card: one epoch of each
    variant at full width on synthetic data with the sorted scatter;
    fusion_ablation_results.json must hold each variant's finite mIoU and
    exact parameter count."""
    import tempfile

    from lmsu_tpu_torch import train_fusion_ablation
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "fusion_ablation_results.json")
        reset_launch_counts()
        t0 = time.perf_counter()
        train_fusion_ablation.main(["--device", str(dev), "--epochs", "1", "--dataset",
                                    "synthetic", "--num-train", "16",
                                    "--num-val", "8", "--batch-size", "8",
                                    "--scatter-impl", "sorted_pallas", "--num-workers", "4",
                                    "--run-prefix", os.path.join(d, "ablation"),
                                    "--output", out])
        secs = time.perf_counter() - t0
        with open(out) as f:
            res = json.load(f)
    launches = {k: v.launches for k, v in kernels().items()}
    if ({k: r["total_params"] for k, r in res.items()} != ABLATION_PARAMS
            or not all(np.isfinite(r["miou"]) for r in res.values())):
        raise AssertionError(f"train_fusion_ablation wrote {res}")
    if any(launches[k] <= 0 for k in ("scatter_sorted_fwd", "scatter_sorted_bwd")):
        raise AssertionError(f"train_fusion_ablation: launches {launches}")
    return {"seconds": secs, "results": res, "launches": launches}


def run_synthetic_cli(dev):
    """The quickstart entry point on the card: one epoch of the concat/256
    model on synthetic data with the sorted scatter, history and checkpoints
    written; then the evaluate entry point on its latest.pth must read back
    the val mIoU the trainer recorded (the same weights, split and eval
    path; within 1e-3, for an argmax that sits on a rounding tie)."""
    import tempfile

    from lmsu_tpu_torch import evaluate, train_synthetic
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    with tempfile.TemporaryDirectory() as d:
        common = ["--device", str(dev), "--num-train", "16", "--num-val", "8",
                  "--batch-size", "8", "--scatter-impl", "sorted_pallas", "--num-workers", "4"]
        reset_launch_counts()
        t0 = time.perf_counter()
        best = train_synthetic.main(common + ["--epochs", "1", "--save-dir", d])
        secs = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels().items()}
        files = sorted(os.listdir(d))
        with open(os.path.join(d, "training_history.json")) as f:
            val_miou = json.load(f)["val_miou"][-1]
        ev = evaluate.main(common + ["--checkpoint", os.path.join(d, "latest.pth"),
                                     "--save-dir", os.path.join(d, "eval")])
    if "latest.pth" not in files or not np.isfinite(best):
        raise AssertionError(f"train_synthetic wrote {files}, best {best}")
    if abs(ev["miou"] - val_miou) > 1e-3 or not np.isfinite(ev["loss"]):
        raise AssertionError(f"evaluate read {ev}, the trainer recorded {val_miou}")
    if any(launches[k] <= 0 for k in ("scatter_sorted_fwd", "scatter_sorted_bwd")):
        raise AssertionError(f"train_synthetic: launches {launches}")
    return {"seconds": secs, "best_val_miou": best, "files": files, "launches": launches,
            "evaluate": ev, "recorded_val_miou": val_miou}


# -- PandaSet-scale frames, packs and train_pandaset ----------------------------

PANDA_POINTS = 100_000  # points a sweep (native/bev_ops.cc:72)
# Frames; short clouds among the train frames. 48 steps at the preset's B=4
# let train-mode BatchNorm's running statistics settle for validation.
PANDA_TRAIN, PANDA_VAL, PANDA_SHORT = 192, 32, 4
PANDA_CLASSES = 42  # PandaSet's raw semseg class ids 0-41


def pandaset_frame(rng, n, nan=0):
    """One frame's arrays as PandaSet's files give them: a 256^2 uint8
    image, a sweep of n points [n, 4] over +-80 m (denser near the sensor;
    about half outside +-50 m), raw class ids in PandaSet's range with the
    drivable set on a road band along x. `nan` points get a NaN x or y."""
    r = 80.0 * rng.uniform(0, 1, n) ** 0.7
    th = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-3, 3, n),
                    rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    road = np.abs(pts[:, 1]) < 8.0
    ids = rng.integers(0, PANDA_CLASSES, n)
    ids[road] = rng.choice([6, 7, 8, 9, 10, 12], int(road.sum()))
    ids[~road & np.isin(ids, [6, 7, 8, 9, 10, 12])] = 1
    if nan:
        at = rng.choice(n, nan, replace=False)
        pts[at[: nan // 2], 0] = np.nan
        pts[at[nan // 2:], 1] = np.nan
    img = rng.integers(0, 200, (IMG, IMG, 3)).astype(np.uint8)
    img[IMG // 2 - 16:IMG // 2 + 16] += 55  # the road, brighter
    return img, pts, ids.astype(np.int64)


def decode_frames(frames, route, **kw):
    """decode_frame over `frames` by `route` ("native" or "numpy"); returns
    (samples, host ms a frame)."""
    from lmsu_tpu_torch.data import native
    from lmsu_tpu_torch.data.pandaset import decode_frame
    real = native._load
    if route == "numpy":
        native._load = lambda: None
    try:
        t0 = time.perf_counter()
        out = [decode_frame(img, pts, ids, grid_size=(GRID, GRID), max_points=NPTS,
                            pc_range=(-50.0, 50.0, -50.0, 50.0), seed=0, index=i, **kw)
               for i, (img, pts, ids) in enumerate(frames)]
        return out, (time.perf_counter() - t0) * 1e3 / len(frames)
    finally:
        native._load = real


def check_nan_frames(frames):
    """Frames with NaN coordinates (sensor dropout): the labels equal those
    of the cloud without its NaN rows (rasterize_bev drops them, both
    routes), and the cell sort puts every NaN point last, in the sentinel
    cell, so no cell takes its features."""
    from lmsu_tpu_torch.data.pandaset import decode_frame
    from lmsu_tpu_torch.data.rasterize import bev_cell_key, make_point_sorter
    pc4, pc6 = (-50.0, 50.0, -50.0, 50.0), (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    sorter = make_point_sorter((GRID, GRID), pc6)
    out = {"nan_rows_kept": 0}
    for i, (img, pts, ids) in enumerate(frames):
        ok = ~np.isnan(pts[:, :2]).any(axis=1)
        s = decode_frame(img, pts, ids, grid_size=(GRID, GRID), max_points=NPTS, pc_range=pc4,
                         seed=0, index=i)
        clean = decode_frame(img, pts[ok], ids[ok], grid_size=(GRID, GRID), max_points=NPTS,
                             pc_range=pc4, seed=0, index=i)
        if not np.array_equal(s["segmentation"], clean["segmentation"]):
            raise AssertionError(f"NaN frame {i}: its labels change with the NaN rows")
        sorted_s = sorter(s)
        nan_at = np.isnan(sorted_s["points"][:, :2]).any(axis=1)
        key = bev_cell_key(sorted_s["points"], (GRID, GRID), pc6, sorted_s["point_valid"])
        if not (key[nan_at] == GRID * GRID).all() or (np.diff(key) < 0).any():
            raise AssertionError(f"NaN frame {i}: a NaN point is not in the sentinel cell")
        out["nan_rows_kept"] += int(nan_at.sum())
    return out


def check_padded_scatter(rng, dev, samples):
    """K1 and K5 against their plain versions on one decoded batch with
    pad_points_are_valid=True (the reference's quirk): each short cloud's
    zero padding lands in the centre cell as thousands of valid, tied rows;
    one cloud also has NaN points (their rows are NaN and invalid: no cell
    may take them). Features relu(points . W + b) at the lidar encoder's
    C=128, so the pad rows tie exactly. K1 bit for bit, K5 exactly, in f32
    and bf16; their times beside the plain versions' and their bounds, and
    K4's (off this path: it spreads a long span over blocks, K1 walks it in
    one), also bit for bit."""
    from lmsu_tpu_torch.data.rasterize import bev_cell_key, make_point_sorter
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    from lmsu_tpu_torch.ops.scatter import points_to_bev_indices
    hw, C = GRID * GRID, 128
    pc6 = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    sorter = make_point_sorter((GRID, GRID), pc6)
    batch = [sorter(s) for s in samples]
    pts = np.stack([s["points"] for s in batch])
    pv = np.stack([s["point_valid"] for s in batch])
    host_key = bev_cell_key(pts, (GRID, GRID), pc6, pv)
    pts_d = torch.from_numpy(pts).to(dev)
    flat_idx, valid = points_to_bev_indices(pts_d[..., :2], (GRID, GRID), pc6)
    keys = ss.cell_keys(flat_idx, valid & torch.from_numpy(pv).to(dev), hw)
    if not np.array_equal(keys.cpu().numpy(), host_key):
        raise AssertionError("padded batch: device cell index != host sort key")
    centre = (GRID - 1) // 2 * GRID + (GRID - 1) // 2
    out = {"centre_cell_rows": [int((k == centre).sum()) for k in host_key],
           "nan_points": int(np.isnan(pts).any(-1).sum())}
    w = torch.from_numpy(rng.normal(0, 1, (4, C)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(0.1, 1, C).astype(np.float32)).to(dev)
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        feats = torch.relu(pts_d @ w + b).to(dtype).contiguous()
        got = ss.segment_max(feats, keys, hw)
        want = ss.segment_max_plain(feats, keys, hw)
        if not torch.equal(got, want) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"scatter_sorted_fwd on the padded batch {dt}: not bit-exact "
                                 f"or not finite")
        if not torch.equal(ss.segment_max_flat(feats, keys, hw), want):
            raise AssertionError(f"scatter_sorted_fwd_flat on the padded batch {dt}: "
                                 f"not bit-exact")
        g = torch.from_numpy(rng.normal(0, 1, (len(batch), hw, C)).astype(np.float32)).to(dev,
                                                                                         dtype)
        d = ss.segment_max_bwd(feats, keys, got, g, hw)
        if not torch.equal(d, ss.segment_max_bwd_plain(feats, keys, got, g, hw)):
            raise AssertionError(f"scatter_sorted_bwd on the padded batch {dt}: not exact")
        out[dt] = {"k1_bound_ms": scatter_bound(feats, keys, hw)[0],
                   "k5_bound_ms": scatter_bwd_bound(feats, keys, hw)[0],
                   "k1_ms": time_ms(lambda: ss.segment_max(feats, keys, hw)),  # noqa: B023
                   "k4_ms": time_ms(lambda: ss.segment_max_flat(feats, keys, hw)),  # noqa: B023
                   "k1_plain_ms": time_ms(lambda: ss.segment_max_plain(feats, keys, hw),  # noqa: B023
                                          reps=10, inner=2),
                   "k5_ms": time_ms(lambda: ss.segment_max_bwd(feats, keys, got, g, hw)),  # noqa: B023
                   "k5_plain_ms": time_ms(
                       lambda: ss.segment_max_bwd_plain(feats, keys, got, g, hw),  # noqa: B023
                       reps=10, inner=2)}
    return out


def run_prepare_on_raw_tree(d, rng):
    """Where PIL and pandas are installed: a raw tree of 2 scenes x 2
    frames at PandaSet's scale, then `python -m lmsu_tpu_torch.prepare_dataset
    --dataset pandaset` on it. Else one line naming what is missing."""
    import importlib.util
    missing = [m for m in ("PIL", "pandas") if importlib.util.find_spec(m) is None]
    if missing:
        return {"skipped": f"{', '.join(missing)} not installed: the raw-tree decode "
                           f"(JPEG, pickles) does not run here"}
    import pandas as pd
    from PIL import Image

    from lmsu_tpu_torch import prepare_dataset
    root = os.path.join(d, "raw")
    for sid in ("001", "002"):
        dirs = [os.path.join(root, sid, *p) for p in (("camera", "front_camera"), ("lidar",),
                                                      ("annotations", "semseg"))]
        for x in dirs:
            os.makedirs(x)
        for f in range(2):
            img, pts, ids = pandaset_frame(rng, PANDA_POINTS)
            Image.fromarray(img).save(os.path.join(dirs[0], f"{f:02d}.jpg"))
            pd.DataFrame({c: pts[:, k] for k, c in enumerate("xyzi")}).to_pickle(
                os.path.join(dirs[1], f"{f:02d}.pkl"))
            pd.DataFrame({"class": ids}).to_pickle(os.path.join(dirs[2], f"{f:02d}.pkl"))
    t0 = time.perf_counter()
    done = prepare_dataset.main(["--dataset", "pandaset", "--root", root, "--train-fraction",
                                 "0.5", "--out", os.path.join(d, "raw_packs"), "--workers", "2"])
    return {"seconds": time.perf_counter() - t0, "packed": {k: v[0] for k, v in done.items()}}


def run_pandaset_cli(dev):
    """PandaSet-scale data through the port on the card. Frames of
    PANDA_POINTS points (PANDA_SHORT training clouds under 5,000 points,
    so the pad path runs) are decoded with data/pandaset.py::decode_frame
    by the native route (where native/libbev_ops.so loads) and by numpy,
    host ms a frame printed for each; two more frames with NaN coordinates
    are checked (check_nan_frames) and kept out of the packs, since a NaN
    point makes train-mode BatchNorm's statistics NaN, in the JAX package as
    in the port. Packs of the train and val frames (write_pack), then one
    epoch of `python -m lmsu_tpu_torch.train_pandaset` at the preset's full
    width (concat/256, 3 classes, batch 4) from them with the sorted
    scatter: its history and latest.pth written, the train loss and mIoU
    finite, K1 and K5 launched. `python -m lmsu_tpu_torch.evaluate
    --num-classes 3 --dataset packed` on latest.pth: a finite loss, and the
    val mIoU the trainer recorded within 1e-3 (both count the 2-class
    matrix). K1 and K5 held to their plain versions on a decoded batch with
    pad_points_are_valid=True (check_padded_scatter). Where PIL and pandas
    are installed, prepare_dataset also decodes a raw tree."""
    import tempfile

    from lmsu_tpu_torch import evaluate, train_pandaset
    from lmsu_tpu_torch.data import native, write_pack
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    rng = np.random.default_rng(15)
    t_start = time.perf_counter()
    frames = [pandaset_frame(rng, int(rng.integers(NPTS // 5, NPTS * 9 // 10)) if i < PANDA_SHORT
                             else int(rng.integers(PANDA_POINTS * 9 // 10, PANDA_POINTS * 11 // 10)))
              for i in range(PANDA_TRAIN + PANDA_VAL)]
    res = {"route": native.route(), "points_a_sweep": int(np.mean([f[1].shape[0]
                                                                   for f in frames]))}
    decoded, res["decode_ms_a_frame"] = decode_frames(frames, native.route())
    if native.route() == "native":
        _, res["decode_ms_a_frame_numpy"] = decode_frames(frames, "numpy")
    log(f"[pandaset] host decode {res['decode_ms_a_frame']:.3f} ms a frame by the "
        f"{res['route']} route ({res['points_a_sweep']} points a sweep; numpy route "
        f"{res.get('decode_ms_a_frame_numpy', res['decode_ms_a_frame']):.3f} ms); {smi_line()}")
    nan_frames = [pandaset_frame(rng, NPTS * 2 // 5, nan=20),
                  pandaset_frame(rng, PANDA_POINTS, nan=200)]
    res["nan_frames"] = check_nan_frames(nan_frames)
    with tempfile.TemporaryDirectory() as d:
        packs, run = os.path.join(d, "packs"), os.path.join(d, "run")
        t0 = time.perf_counter()
        for split, part in (("train", decoded[:PANDA_TRAIN]), ("val", decoded[PANDA_TRAIN:])):
            write_pack([{**x, "sample_token": f"{split}_{i:03d}"} for i, x in enumerate(part)],
                       os.path.join(packs, split))
        res["pack_seconds"] = time.perf_counter() - t0
        common = ["--device", str(dev), "--dataset", "packed", "--data-root", packs,
                  "--scatter-impl", "sorted_pallas", "--num-workers", "4"]
        reset_launch_counts()
        t0 = time.perf_counter()
        best = train_pandaset.main(common + ["--epochs", "1", "--save-dir", run])
        res["epoch_seconds"] = time.perf_counter() - t0
        res["launches"] = {k: v.launches for k, v in kernels().items()}
        files = sorted(os.listdir(run))
        with open(os.path.join(run, "training_history.json")) as f:
            hist = json.load(f)
        ev = evaluate.main(common + ["--checkpoint", os.path.join(run, "latest.pth"),
                                     "--num-classes", "3", "--save-dir", os.path.join(d, "ev")])
        res["raw_tree"] = run_prepare_on_raw_tree(d, rng)
    if ("latest.pth" not in files or not np.isfinite(best)
            or not np.isfinite(hist["train_loss"] + hist["val_miou"]).all()):
        raise AssertionError(f"train_pandaset wrote {files}, history {hist}, best {best}")
    if any(res["launches"][k] <= 0 for k in ("scatter_sorted_fwd", "scatter_sorted_bwd")):
        raise AssertionError(f"train_pandaset: launches {res['launches']}")
    if not np.isfinite(ev["loss"]) or abs(ev["miou"] - hist["val_miou"][-1]) > 1e-3:
        raise AssertionError(f"evaluate read {ev}, the trainer recorded {hist['val_miou']}")
    res.update({"best_val_miou": best, "history": hist, "evaluate": ev, "files": files})
    pad_samples, _ = decode_frames([frames[0], nan_frames[0], frames[PANDA_SHORT],
                                    frames[1]], native.route(), pad_points_are_valid=True)
    res["padded_scatter"] = check_padded_scatter(rng, dev, pad_samples)
    res["seconds"] = time.perf_counter() - t_start
    return res


# -- the best KD recipe (best_overall_results.json) -----------------------------

# scripts/experiment_best_overall.py's flags (--scan-steps 13: the 13 batches
# of 400 samples at B=32 make one chunk), one teacher epoch and one distill
# epoch on 400 + 64 hard synthetic samples.
RECIPE_ARGS = ["--difficulty", "hard", "--num-train", "400", "--num-val", "64",
               "--batch-size", "32", "--epochs", "1", "--teacher-epochs", "1",
               "--fusion-type", "minimal", "--fusion-channels", "128", "--cache-teacher",
               "--temperature", "4", "--augment", "--aug-hflip", "0", "--scan-steps", "13",
               "--scatter-impl", "pallas", "--use-pallas-kd", "--num-workers", "4"]
# scripts/experiment_crossarch_best.py's flags (a weighted/128 PointPillars
# student, a spatial 2x teacher), at the same depth, with the pallas scatter
# and the feature-MSE kernel.
CROSSARCH_ARGS = ["--difficulty", "hard", "--num-train", "400", "--num-val", "64",
                  "--batch-size", "32", "--epochs", "1", "--teacher-epochs", "1",
                  "--lidar-encoder", "pointpillars", "--teacher-lidar-encoder", "spatial",
                  "--cache-teacher", "--temperature", "4", "--augment", "--aug-hflip", "0",
                  "--scan-steps", "13", "--scatter-impl", "pallas", "--use-pallas-kd",
                  "--num-workers", "4"]


def recipe_augment():
    """The recipe's augmentation: the standard terms without the flip."""
    from lmsu_tpu_torch.common import STANDARD_AUGMENT
    from lmsu_tpu_torch.config import AugmentConfig
    return AugmentConfig(**{**STANDARD_AUGMENT, "hflip_prob": 0.0})


class Tee(io.TextIOBase):
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def check_augment_on_card(dev):
    """apply_augment on the card against the same call on the CPU, with the
    same draws (made on the CPU): every term on, a uint8 batch at B=8 with a
    prior point_valid. Flips (labels) and masks exactly, the image and the
    points (mirror and jitter) within 1e-6 of scale."""
    from lmsu_tpu_torch.config import AugmentConfig
    from lmsu_tpu_torch.ops import augment
    cfg = AugmentConfig(enabled=True, hflip_prob=0.5, brightness=0.1, contrast=0.1,
                        image_noise_std=0.02, point_dropout=0.05, point_jitter_xy=0.05,
                        point_jitter_z=0.05, intensity_jitter=0.02)
    rng = np.random.default_rng(17)
    pts = rng.normal(0, 30, (B, NPTS, 4)).astype(np.float32)
    cpu = {"image": torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)),
           "points": torch.from_numpy(pts),
           "segmentation": torch.from_numpy(rng.integers(-1, 2, (B, GRID, GRID))),
           "point_valid": torch.from_numpy(rng.uniform(size=(B, NPTS)) > 0.1)}
    draws = augment.draw_augment(torch.Generator().manual_seed(3), cfg, cpu)
    pc = (-50.0, 50.0, -50.0, 50.0)
    want = augment.apply_augment(cpu, draws, cfg, pc)
    got = augment.apply_augment({k: v.to(dev) for k, v in cpu.items()},
                                {k: v.to(dev) for k, v in draws.items()}, cfg, pc)
    got = {k: v.cpu() for k, v in got.items()}
    flips = int(draws["flip"].sum())
    res = {"flipped": flips, "dropped": int((~draws["keep"]).sum()),
           "segmentation_equal": torch.equal(got["segmentation"], want["segmentation"]),
           "point_valid_equal": torch.equal(got["point_valid"], want["point_valid"]),
           "image_err": float((got["image"] - want["image"]).abs().max()),
           "points_err": float((got["points"] - want["points"]).abs().max()
                               / want["points"].abs().max())}
    if not (0 < flips < B and res["segmentation_equal"] and res["point_valid_equal"]
            and res["image_err"] <= 1e-6 and res["points_err"] <= 1e-6
            and got["image"].dtype == torch.float32):
        raise AssertionError(f"augmentation on the card != on the CPU: {res}")
    return res


def run_recipe_cli(dev, d, name="student", args=None, extra=()):
    """A KD recipe through `python -m lmsu_tpu_torch.train_distill` at full
    width (the best recipe, RECIPE_ARGS, unless `args` say otherwise, plus
    `extra`): one teacher epoch, the cache on the device under a 6 GiB
    budget (its size printed), one distill epoch; the history is written,
    K6 and K7 launched. Returns the run's seconds, each phase's epoch line
    (its seconds and input stall) and the launches."""
    from lmsu_tpu_torch import train_distill
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    run = os.path.join(d, name)
    reset_launch_counts()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train_distill.main(["--device", str(dev), "--train-teacher", "--cache-hbm-gb", "6",
                                   "--save-dir", run] + list(args or RECIPE_ARGS) + list(extra))
    secs = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels().items()}
    lines = tee.kept.getvalue().splitlines()
    cache = [ln for ln in lines if ln.startswith("teacher cache:")]
    epochs = [ln.split("]")[0] + "]" for ln in lines if ln.startswith("Epoch 1/1")]
    with open(os.path.join(run, "training_history.json")) as f:
        hist = json.load(f)
    if (len(cache) != 1 or "on the device" not in cache[0] or not np.isfinite(best)
            or len(hist["train_loss"]) != 1 or len(epochs) != 2
            or any(launches[k] <= 0 for k in ("voxelize_scatter_max", "kd_feature_mse"))):
        raise AssertionError(f"recipe {name}: cache {cache}, best {best}, history {hist}, "
                             f"launches {launches}")
    return {"seconds": secs, "best_val_miou": best, "cache": cache[0], "history": hist,
            "epochs_teacher_then_student": epochs, "launches": launches}


def check_recipe_spill(dev, d):
    """The recipe's distill with the default 4 GiB limit, from the teacher
    the CLI trained: the cache must spill to host memory, and the first
    batch's gathered targets must equal, bit for bit, those of the same
    distill with the 6 GiB limit (cache on the device). Then the cost of the
    spill per step: each batch's gather (host gather, pinned staging,
    copy; against the device's index_select), and one distill epoch of
    each."""
    import dataclasses

    from lmsu_tpu_torch import train_distill
    from lmsu_tpu_torch.common import build_loaders
    from lmsu_tpu_torch.training import DistillationTrainer
    args = train_distill.make_parser().parse_args(
        RECIPE_ARGS + ["--device", str(dev), "--save-dir", os.path.join(d, "spill"),
                       "--teacher-checkpoint", os.path.join(d, "student_teacher", "latest.pth")])
    cfg, tcfg = train_distill.build_configs(args)
    loaders = build_loaders(cfg, verbose=False)
    six = cfg.replace(train=dataclasses.replace(cfg.train, kd=dataclasses.replace(
        cfg.train.kd, cache_hbm_limit_bytes=6 << 30)))
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        host = DistillationTrainer(cfg, *loaders, teacher_model_config=tcfg, device=dev)
        host.build_teacher_cache()
        ondev = DistillationTrainer(six, *loaders, teacher_model_config=tcfg, device=dev)
        ondev.build_teacher_cache()
    if host.teacher_cache_host is None or ondev.teacher_cache is None:
        raise AssertionError("recipe spill: the 4 GiB cache did not spill, or the 6 GiB one did")
    first = next(iter(loaders[0]))
    b = ondev._to_device(first)
    (hl, ht), (dl, dt) = host.gather_teacher(first, b), ondev.gather_teacher(first, b)
    equal = torch.equal(hl, dl) and all(torch.equal(ht[k], dt[k]) for k in dt)
    if not equal:
        raise AssertionError("recipe spill: the spilled targets differ from the device cache's")
    gather = {"host": [], "device": []}
    for batch in loaders[0]:
        b = ondev._to_device(batch)
        for side, tr in (("host", host), ("device", ondev)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.gather_teacher(batch, b)
            torch.cuda.synchronize()
            gather[side].append((time.perf_counter() - t0) * 1e3)
    epoch = {}
    for side, tr in (("host", host), ("device", ondev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_epoch()
        torch.cuda.synchronize()
        epoch[side] = {"seconds": time.perf_counter() - t0, "loss": loss}
    steps = len(gather["host"])
    out = {"cache_lines": [ln for ln in tee.kept.getvalue().splitlines()
                           if ln.startswith("teacher cache:")],
           "first_batch_bit_equal": equal, "steps": steps,
           "gather_ms_per_step": {k: float(np.mean(v)) for k, v in gather.items()},
           "epoch": epoch,
           "spill_ms_per_step": (epoch["host"]["seconds"] - epoch["device"]["seconds"])
           * 1e3 / steps}
    del host, ondev
    torch.cuda.empty_cache()
    return out


def check_ensemble(dev):
    """Teacher ensembles on the card, minimal/128 with the pallas scatter,
    f32, B=8: the K=2 ensemble's logits and taps equal the mean of its two
    members' own forwards, one in-loop K=2 step runs, and K=1 (a
    one-member EnsembleTeacher, and ensemble_size=1) gives the single
    teacher's outputs bit for bit."""
    from lmsu_tpu_torch.training import DistillationTrainer
    from lmsu_tpu_torch.training.distill import EnsembleTeacher
    rng = np.random.default_rng(13)
    batch = train_batch(rng, B, dev, sort=False)

    def trainer(k):
        return DistillationTrainer(train_config(torch.float32, batch=B, scatter="pallas",
                                                model="minimal", kd={"ensemble_size": k}),
                                   [batch], [batch], device=dev)
    two = trainer(2)
    logits, taps = two.teacher_forward(batch)
    with torch.no_grad():
        outs = [m(batch["image"], batch["points"], return_intermediates=True)
                for m in two.teacher.members]
        one = EnsembleTeacher([two.teacher.members[0]])(batch["image"], batch["points"],
                                                        return_intermediates=True)
    mean_l = torch.stack([o[0] for o in outs]).mean(0)
    errs = {"logits": float((logits - mean_l).abs().max() / mean_l.abs().max())}
    for k, v in taps.items():
        want = torch.stack([o[1][k] for o in outs]).mean(0)
        errs[k] = float((v - want).abs().max() / want.abs().max())
    loss, _ = two.train_step(batch)
    single = trainer(1)
    s_logits, s_taps = single.teacher_forward(batch)
    k1_equal = (torch.equal(s_logits, outs[0][0]) and torch.equal(one[0], outs[0][0])
                and all(torch.equal(s_taps[k], outs[0][1][k]) for k in s_taps)
                and all(torch.equal(one[1][k], outs[0][1][k]) for k in outs[0][1]))
    res = {"k2_rel_err": errs, "k2_step_loss": float(loss), "k1_bit_equal": k1_equal}
    if max(errs.values()) > 1e-6 or not np.isfinite(res["k2_step_loss"]) or not k1_equal:
        raise AssertionError(f"ensemble on the card: {res}")
    return res


# -- chained steps, on-device epochs, run control -----------------------------


class PermutedLoader:
    """Host batches of a materialized set in the order of a permutation:
    the host loop over the on-device epoch's batches."""

    def __init__(self, host, perm, batch):
        self.host, self.perm, self.batch = host, perm, batch

    def __len__(self):
        return len(self.perm) // self.batch

    def __iter__(self):
        for i in range(len(self)):
            idx = self.perm[i * self.batch:(i + 1) * self.batch]
            yield {k: v[idx] for k, v in self.host.items()}


def epoch_result(tr, before, loss, log):
    """(epoch loss, update of every parameter over the epoch, BN running
    statistics in float64, and the steps' `instrument` log: fingerprints
    stacked [steps, tensors], losses)."""
    stats = {k: v.detach().double() for k, v in tr.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    steps = {k: torch.stack(v) for k, v in log.items() if k != "loss"}
    return (loss, {k: (p.detach() - before[k]).double() for k, p in tr.params.items()}, stats,
            {**steps, "loss": list(log["loss"])})


@contextlib.contextmanager
def deterministic_cudnn():
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det


def fingerprint(tensors) -> torch.Tensor:
    """An exact checksum of each tensor, on the device, no read-back: the
    sum of its elements' bits (as integers) times their position's weight,
    in wrapping int64 arithmetic, so the order of the sum does not matter."""
    sums = []
    for t in tensors:
        t = t.contiguous()
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        flat = t.view(bits).reshape(-1).long()
        sums.append((flat * (torch.arange(flat.numel(), device=t.device) % 65521 + 1)).sum())
    return torch.stack(sums)


def instrument(tr) -> dict:
    """Record, for every train step of `tr`, a fingerprint of the batch the
    step trains on (on the device, before augmentation), of the teacher
    rows it gets (gathered from the cache or passed in) and its loss."""
    log = {"batch": [], "teacher": [], "loss": []}
    step, augmented, gather = tr.train_step, tr._augmented, tr.gather_teacher

    def taps(out):
        return fingerprint([out[0]] + [out[1][k] for k in sorted(out[1])])

    def train_step(batch, teacher_out=None):
        if teacher_out is not None:
            log["teacher"].append(taps(teacher_out))
        loss, cm = step(batch, teacher_out=teacher_out)
        log["loss"].append(loss)
        return loss, cm

    def augmented_(b):
        log["batch"].append(fingerprint([b[k] for k in sorted(b)]))
        return augmented(b)

    def gather_teacher(batch, b):
        out = gather(batch, b)
        log["teacher"].append(taps(out))
        return out
    tr.train_step, tr._augmented, tr.gather_teacher = train_step, augmented_, gather_teacher
    return log


def hold_epoch(what, got, want, noise) -> dict:
    """Hold an epoch `got` (epoch_result) against `want`, with `noise` the
    `want` epoch from weights moved by 1e-6 of themselves:
      inputs            every step's batch and teacher rows bit for bit
                        (fingerprints), in `noise` too: the loops must feed
                        the same data in the same order;
      the first step    its loss |d| <= 1e-5 |l| (same weights, same data);
      the epoch loss, each BN running statistic
                        hold_step's fixed limits (1e-5 |l|; 1e-4 max|s| +
                        1e-6) plus 10x the spread N, uncapped;
      all parameter updates
                        relative L2 <= 1e-3 + 10 N, uncapped.
    hold_step caps the spread (loss 1e-4, gradients 0.1): one step's
    arithmetic noise stays under those caps, but thirteen AdamW steps carry
    it far past them. The first calls on the card, with deterministic cuDNN
    (the stock ops' atomic sums still reorder), read the chunk's epoch loss
    5.8e-4 relative from the host loop's against a spread of 7.7e-4, and the
    updates 0.14 relative L2 against 0.32; a single step's loss late in the
    epoch can move by 10x its own one-sample spread (step 11: 3.2e-3 against
    3.1e-4), so the steps after the first are printed (the largest ratio of
    difference to spread), not held one by one. After the first step the
    spread alone bounds the arithmetic, and the inputs, held exactly, carry
    the check that the loops train on the same batches."""
    (la, ua, sa, ga), (lb, ub, sb, gb), (lp, up, sp, gp) = got, want, noise
    for k in ("batch", "teacher"):
        if not (torch.equal(ga[k], gb[k]) and torch.equal(gp[k], gb[k])):
            bad = [i for i in range(len(gb[k])) if not torch.equal(ga[k][i], gb[k][i])]
            raise AssertionError(f"{what}: the steps {bad} saw other {k} inputs")
    losses = [(float(a), float(b), float(c)) for a, b, c in zip(ga["loss"], gb["loss"],
                                                                  gp["loss"])]
    if not abs(losses[0][0] - losses[0][1]) <= 1e-5 * abs(losses[0][1]):
        raise AssertionError(f"{what}: first step's loss {losses[0]}")
    if not abs(la - lb) <= 1e-5 * abs(lb) + 10 * abs(lp - lb):
        raise AssertionError(f"{what}: epoch loss {la} != {lb} (perturbed {lp})")
    step_ratio = max(abs(a - b) / max(abs(c - b), 1e-12) for a, b, c in losses[1:])
    norm = sum((u ** 2).sum().item() for u in ub.values()) ** 0.5
    rel = sum(((ua[k] - ub[k]) ** 2).sum().item() for k in ub) ** 0.5 / norm
    spread = sum(((up[k] - ub[k]) ** 2).sum().item() for k in ub) ** 0.5 / norm
    if not rel <= 1e-3 + 10 * spread:
        raise AssertionError(f"{what}: updates' relative L2 error {rel:g}, spread {spread:g}")
    worst = (0.0, "")
    for k in sb:
        e = (sa[k] - sb[k]).abs().max().item()
        tol = 1e-4 * sb[k].abs().max().item() + 1e-6 + 10 * (sp[k] - sb[k]).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"{what}: bn_stat {k}: err {e:g} > {tol:g}")
        worst = max(worst, (e / tol, k))
    return {"steps_same_inputs": len(losses), "first_step_loss": losses[0],
            "loss": la, "loss_want": lb, "loss_perturbed": lp,
            "later_steps_max_loss_err_over_spread": step_ratio, "update_rel_l2_err": rel,
            "update_rel_l2_spread": spread, "bn_stat_worst_err_over_limit": worst[0],
            "bn_stat_worst": worst[1]}


def same_epoch(a, b) -> bool:
    """Whether two epoch_result()s are equal bit for bit."""
    return (a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in b[1])
            and all(torch.equal(a[2][k], b[2][k]) for k in b[2])
            and all(torch.equal(x, y) for x, y in zip(a[3]["loss"], b[3]["loss"])))


def recipe_loops(dev, d):
    """The best recipe's distill epoch (its flags, the teacher the CLI
    trained, the cache on the device) through each loop, from the same
    weights: the host loop (scan_steps 1), the 13-step chunk (scan_steps
    13: the epoch's 13 batches in one chunk), the on-device epoch and the
    contiguous on-device epoch. Each epoch's seconds (synchronised) and,
    over one more profiled epoch, the device's idle share. The chunk is
    held to the host loop, and the on-device epochs to the host loop run
    over the same permuted batches, by hold_epoch: every step's inputs bit
    for bit, the first step's loss within 1e-5, the epoch's loss, updates
    and BN statistics within hold_step's fixed limits plus 10x the host
    loop's own spread (the same epoch from weights moved by 1e-6 of
    themselves), uncapped. The epochs run with
    deterministic cuDNN; whether the loops then agree bit for bit is
    printed, not asked. One teacher cache serves every trainer."""
    import dataclasses

    from lmsu_tpu_torch import train_distill
    from lmsu_tpu_torch.common import build_loaders
    from lmsu_tpu_torch.data import materialize_dataset
    from lmsu_tpu_torch.training import DistillationTrainer
    args = train_distill.make_parser().parse_args(
        RECIPE_ARGS + ["--device", str(dev), "--save-dir", os.path.join(d, "loops"),
                       "--teacher-checkpoint", os.path.join(d, "student_teacher", "latest.pth")])
    base, tcfg = train_distill.build_configs(args)
    base = base.replace(train=dataclasses.replace(base.train, kd=dataclasses.replace(
        base.train.kd, cache_hbm_limit_bytes=6 << 30)))
    loaders = build_loaders(base, verbose=False)
    cache = {}

    def trainer(perturb=0.0, **train):
        cfg = base.replace(train=dataclasses.replace(base.train, **train))
        tr = DistillationTrainer(cfg, *loaders, teacher_model_config=tcfg, device=dev)
        if cache:
            tr.teacher_cache = cache
        else:
            tr.build_teacher_cache()
            cache.update(tr.teacher_cache)
        if perturb:
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for p in tr.params.values():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(dev))
        return tr

    def epoch(tr, loader=None, profile=False):
        loaders[0].set_epoch(0)
        log = instrument(tr)
        before = {k: p.detach().clone() for k, p in tr.params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_epoch() if loader is None else tr._run_epoch(loader, True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = epoch_result(tr, before, loss, log)
        out = {"seconds": secs, "loss": loss, "steps": tr.step,
               "input_stall": tr.last_host_stall_frac}
        if profile:
            prof = profile_steps(lambda: (tr.train_epoch() if loader is None
                                          else tr._run_epoch(loader, True)), reps=1)
            out.update(idle_share=prof["idle_share"], device_ms=prof["device_ms"],
                       wall_ms=prof["wall_ms"])
        return res, out

    report, held = {}, {}
    with deterministic_cudnn():
        host, report["host_loop"] = epoch(trainer(), profile=True)
        host_p, _ = epoch(trainer(perturb=1e-6))
        chunk, report["chunk_13"] = epoch(trainer(scan_steps=13), profile=True)
        held["chunk_13_vs_host_loop"] = hold_epoch("recipe epoch: 13-step chunk vs host loop",
                                                   chunk, host, host_p)
        held["chunk_13_bit_equal"] = same_epoch(chunk, host)
        batcher = loaders[0].batcher
        mat = materialize_dataset(batcher.dataset, batcher.batch_size,
                                  batcher.sample_transform)
        perm = np.random.default_rng(np.random.SeedSequence(
            [base.train.seed, 0, 104729])).permutation(len(mat["sample_mask"]))
        ordered = PermutedLoader(mat, perm, batcher.batch_size)
        ref, report["host_loop_in_onchip_order"] = epoch(trainer(), ordered)
        ref_p, _ = epoch(trainer(perturb=1e-6), ordered)
        for name, kw in (("onchip", {}), ("onchip_contiguous", {"onchip_contiguous": True})):
            got, report[name] = epoch(trainer(onchip_epoch=True, **kw), profile=True)
            held[f"{name}_vs_host_loop"] = hold_epoch(f"recipe epoch: {name} vs host loop",
                                                      got, ref, ref_p)
            held[f"{name}_bit_equal"] = same_epoch(got, ref)
    steps = {v["steps"] for v in report.values()}
    if steps != {13}:
        raise AssertionError(f"recipe loops: steps {report}")
    cache.clear()
    torch.cuda.empty_cache()
    return {"epochs": report, "held": held}


def check_remat_step(dev):
    """One in-loop KD step of the weighted/128 student at B=128, f32, with
    CameraEncoderConfig.remat against the same step without it, unfused and
    with fused_train, deterministic cuDNN: the loss, every gradient and every
    BN running statistic after the step held by hold_step's fixed limits
    (remat recomputes the stages' forwards in the backward pass; the
    running statistics must move once)."""
    rng = np.random.default_rng(19)
    batch = train_batch(rng, TRAIN_B, dev)
    out = {}
    with deterministic_cudnn():
        for fused in (False, True):
            steps = [kd_step(dev, batch, train_config(torch.float32, fused_train=fused,
                                                      remat=remat))
                     for remat in (True, False)]
            out["fused_train" if fused else "unfused"] = hold_step(
                f"remat KD step ({'fused' if fused else 'unfused'}) vs the same step without",
                *steps)
    torch.cuda.empty_cache()
    return out


def check_sigterm_resume(dev, d):
    """`python -m lmsu_tpu_torch.train_distill --handle-sigterm` in a child
    process (weighted/128 student, random 2x teacher, cache on the device,
    scan_steps 2, 64 + 32 hard samples at B=32, two epochs) gets SIGTERM as
    its first epoch fills the teacher cache: it must finish that epoch, write
    latest.pth, say it was preempted and exit 0. `--resume` with
    `--async-checkpoint --snapshot-every 1` then finishes the run: two
    epochs in the history, epoch_002.pth written, and it loads as a
    --teacher-checkpoint."""
    import signal

    from lmsu_tpu_torch.models import create_model
    from lmsu_tpu_torch.training.distill import _load_teacher_state
    run = os.path.join(d, "sigterm")
    cmd = [sys.executable, "-u", "-m", "lmsu_tpu_torch.train_distill", "--device", str(dev),
           "--difficulty", "hard", "--num-train", "64", "--num-val", "32", "--batch-size", "32",
           "--epochs", "2", "--cache-teacher", "--scan-steps", "2", "--scatter-impl", "pallas",
           "--use-pallas-kd", "--num-workers", "4", "--handle-sigterm", "--save-dir", run]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out, sent = [], False
    try:
        for line in proc.stdout:
            out.append(line.rstrip())
            if not sent and line.startswith("teacher cache:"):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    first = time.perf_counter() - t0
    with open(os.path.join(run, "training_history.json")) as f:
        hist1 = json.load(f)
    latest = torch.load(os.path.join(run, "latest.pth"), map_location="cpu", weights_only=False)
    if (rc != 0 or not sent or not any(ln.startswith("Preempted") for ln in out)
            or len(hist1["val_miou"]) != 1 or latest["epoch"] != 0):
        raise AssertionError(f"SIGTERM run: rc {rc}, sent {sent}, history {hist1}, "
                             f"output tail {out[-8:]}")
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--resume", "--async-checkpoint", "--snapshot-every", "1"],
                         cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300)
    second = time.perf_counter() - t0
    with open(os.path.join(run, "training_history.json")) as f:
        hist2 = json.load(f)
    snap = os.path.join(run, "epoch_002.pth")
    if (res.returncode != 0 or len(hist2["val_miou"]) != 2
            or hist2["val_miou"][0] != hist1["val_miou"][0] or not os.path.exists(snap)
            or os.path.exists(os.path.join(run, "epoch_001.pth"))):
        raise AssertionError(f"resume after SIGTERM: rc {res.returncode}, history {hist2}, "
                             f"files {sorted(os.listdir(run))}, "
                             f"output tail {res.stdout.splitlines()[-8:]}")
    from lmsu_tpu_torch import train_distill
    cfg, _ = train_distill.build_configs(train_distill.make_parser().parse_args([]))
    create_model(cfg.model).load_state_dict(_load_teacher_state(snap), strict=True)
    return {"preempted_run_seconds": first, "resumed_run_seconds": second,
            "val_miou": hist2["val_miou"], "files": sorted(os.listdir(run)),
            "preempt_line": [ln for ln in out if ln.startswith("Preempted")][0]}


def check_async_checkpoint(dev, d):
    """An async save (snapshot included) and a synchronous save of the same
    trainer state on the card (the weighted/128 student's KD trainer after
    one B=8 step) load equal, every tensor bit for bit; the async save
    returns before its write, which the flush waits for."""
    import dataclasses

    from lmsu_tpu_torch.training import DistillationTrainer
    from lmsu_tpu_torch.training import checkpoint as ckpt
    rng = np.random.default_rng(23)
    batch = train_batch(rng, B, dev)
    cfg = train_config(torch.float32, batch=B)
    out = {}
    tr = DistillationTrainer(cfg, [batch], [batch], device=dev,
                             teacher_model_config=teacher_for(cfg))
    tr.train_step(batch)
    for name, on in (("async", True), ("sync", False)):
        tr.config = cfg.replace(train=dataclasses.replace(cfg.train, async_checkpoint=on))
        tr.save_dir = os.path.join(d, f"ckpt_{name}")
        t0 = time.perf_counter()
        tr.save_checkpoint(0, 0.5, is_best=True, snapshot=ckpt.snapshot_name(0))
        out[f"{name}_save_returns_ms"] = (time.perf_counter() - t0) * 1e3
        tr.flush_checkpoints()

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(equal(u, v) for u, v in zip(x, y))
        return x == y
    for f in (ckpt.LATEST, ckpt.BEST, ckpt.snapshot_name(0)):
        a, s = (ckpt.load_checkpoint(os.path.join(d, f"ckpt_{n}", f)) for n in ("async", "sync"))
        if not equal(a, s):
            raise AssertionError(f"async checkpoint {f} differs from the synchronous one")
    out["files_equal"] = True
    return out


def check_debug_nans(dev):
    """debug_nans on the kernel path (sorted scatter K1/K5, fused gate K2,
    K7; weighted/128 at B=8, f32): a clean step runs; one point's intensity
    NaN raises FloatingPointError at the first LiDAR module, the teacher's
    in-loop encoder running first."""
    import dataclasses

    from lmsu_tpu_torch.training import DistillationTrainer
    rng = np.random.default_rng(29)
    batch = train_batch(rng, B, dev)
    cfg = train_config(torch.float32, batch=B)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, debug_nans=True))
    tr = DistillationTrainer(cfg, [batch], [batch], device=dev,
                             teacher_model_config=teacher_for(cfg))
    loss, _ = tr.train_step(batch)
    bad = dict(batch, points=batch["points"].clone())
    bad["points"][0, 7, 3] = float("nan")
    try:
        tr.train_step(bad)
    except FloatingPointError as e:
        msg = str(e)
    else:
        raise AssertionError("debug_nans: a NaN intensity raised nothing")
    if "lidar_encoder" not in msg or not np.isfinite(float(loss)):
        raise AssertionError(f"debug_nans: {msg}; clean loss {float(loss)}")
    return {"clean_loss": float(loss), "error": msg}


# -- main --------------------------------------------------------------------


# -- data parallelism: process groups, synced BN, fsdp, DP serving -------------

# The runs of the two-rank check (name, dtype, fused_train, teacher_partition);
# the fsdp run is held to the replicated f32 fused run's reference, and so is
# the run with K11's r2 sums left local (a planted fault, `planted_fault`):
# its reading is recorded, to show what the step check sees of such a fault.
PARALLEL_RUNS = (("f32_fused", torch.float32, True, "tp"), ("f32", torch.float32, False, "tp"),
                 ("bf16_fused", torch.bfloat16, True, "tp"), ("bf16", torch.bfloat16, False, "tp"),
                 ("f32_fused_fsdp", torch.float32, True, "fsdp"),
                 ("f32_fused_fault_r2", torch.float32, True, "tp"))
PARALLEL_STEPS = 3
# The glue of the fused blocks (ops/ir_fused.py::_global) a fault can be
# planted in: the source text of the call whose reduction is left out.
GLUE_FAULTS = {"bn1": "_global(*stats1(x, w1), count=M1)",   # K8's sums (and M1)
               "bn3": "_global(y32.sum((0, 1, 2))",           # BN3's sums
               "r2": "_global(r2a, r2b)"}                      # K11's backward sums
# The fixed limits of the glue check (`glue_check`), per dtype: relative L2
# of out, dx and each parameter's gradient; largest difference of a batch
# statistic over its largest magnitude. dx's is wider: where the statistics'
# last bits differ, a ReLU6 mask entry of BN1 or BN2 can flip, which moves
# the dx of that pixel by about its own size (one pixel of the 2^20 of a
# stage's rank reads ~1e-3; an H100 read 4.1e-4 in f32 at 128x128 32->64),
# while the sums over the batch (out's statistics, the gradients) barely see it.
GLUE_LIMITS = {torch.float32: {"out": 1e-4, "dx": 5e-3, "grad": 1e-4, "stat": 1e-5},
               torch.bfloat16: {"out": 2e-3, "dx": 1e-2, "grad": 2e-3, "stat": 1e-4}}


def run_name(name: str) -> str:
    """The one-process run a two-rank run is held to."""
    return name.replace("_fsdp", "").split("_fault_")[0]


@contextlib.contextmanager
def planted_fault(site):
    """Leave out one reduction of the fused blocks' glue: the call of
    ops/ir_fused.py::_global at GLUE_FAULTS[site] returns this rank's sums
    as they are (with them its row count, where it passes one). Yields a
    dict whose "hits" counts the reductions left out; `site` None plants
    nothing."""
    if site is None:
        yield {"hits": 0}
        return
    import linecache
    from lmsu_tpu_torch.ops import ir_fused as irf
    real, marker, hits = irf._global, GLUE_FAULTS[site], {"hits": 0}

    def faulty(*vecs, count=None):
        f = sys._getframe(1)
        if marker in linecache.getline(f.f_code.co_filename, f.f_lineno):
            hits["hits"] += 1
            return (*vecs, count)
        return real(*vecs, count=count)
    irf._global = faulty
    try:
        yield hits
    finally:
        irf._global = real


def glue_inputs(dev, dtype, H, Cin, Cout, stride, exp, B, seed):
    """A fused block's inputs at batch B, made on the card from `seed` (the
    same on every rank): x a ReLU6-like output whose samples each have their
    own scale (so that a part of the batch has other statistics than the
    whole), f32 parameters in the JAX package's layout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    u = lambda *s: torch.rand(*s, generator=g, device=dev)   # noqa: E731
    Ce = Cin * exp
    x = (3 * u(B, H, H, Cin) * (0.25 + 1.5 * u(B, 1, 1, 1))).to(dtype)
    w1 = r(Cin, Ce) * (2.0 / Cin) ** 0.5 if exp != 1 else torch.zeros(Cin, Ce, device=dev)
    gb = [0.5 + u(c) if i % 2 == 0 else 0.2 * r(c)
          for i, c in enumerate((Ce, Ce, Ce, Ce, Cout, Cout))]
    if exp == 1:
        gb[0], gb[1] = torch.zeros(Ce, device=dev), torch.zeros(Ce, device=dev)
    dw, w2 = r(3, 3, Ce) * (2.0 / 9) ** 0.5, r(Ce, Cout) * (2.0 / Ce) ** 0.5
    return x, [w1, gb[0], gb[1], dw, gb[2], gb[3], w2, gb[4], gb[5]]


def glue_block(x, leaves, stride, has, mesh=None):
    """fused_ir_train forward and backward of the loss sum(out^3) / 3 (its
    gradient out^2 depends on out, as a real loss's does, so the backward
    sums are not noise), on `mesh` (its parameters' gradients summed over
    the ranks, as the trainer does). Returns out, dx, the gradients and the
    six batch statistics."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    from lmsu_tpu_torch.parallel.mesh import all_reduce_
    xs = x.detach().clone().requires_grad_(True)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    out, stats = irf.fused_ir_train(xs, *ps, stride, has)
    (out.float() ** 3).sum().div(3).backward()
    grads = [all_reduce_(p.grad.contiguous(), mesh=mesh) if mesh is not None else p.grad
             for p in ps]
    return {"out": out.detach(), "dx": xs.grad, "grads": grads, "stats": stats}


def glue_errors(got, want, rows) -> dict:
    """got's distances from want (glue_block's results; got on `rows` of
    want's batch): relative L2 of out, dx and the worst parameter gradient,
    and the worst batch statistic's largest difference over its largest
    magnitude."""
    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30)).item()
    return {"out": rel(got["out"], want["out"][rows]), "dx": rel(got["dx"], want["dx"][rows]),
            "grad": max(rel(a, b) for a, b in zip(got["grads"], want["grads"])
                        if b.abs().max() > 0),
            "stat": max(((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
                        for a, b in zip(got["stats"], want["stats"]) if b.abs().max() > 0)}


def glue_check(dev, mesh, B=TRAIN_B, stages=IR_STAGES) -> dict:
    """The fused blocks' glue on `mesh`, one block at a time: each of the
    student's stages at the global batch B, f32 and bf16, this rank's rows
    against the one-process block over the whole batch (run here with no
    mesh active), then with each GLUE_FAULTS fault planted. Returns
    {"<dtype> <stage>": {"clean": errors, <site>: errors, "hits": {site: n}}}
    for the caller to hold to GLUE_LIMITS."""
    from lmsu_tpu_torch.parallel import mesh as pm
    L = B // mesh.world_size
    rows = slice(mesh.rank * L, (mesh.rank + 1) * L)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (H, Cin, Cout, stride, exp) in enumerate(stages):
            has = exp != 1
            x, leaves = glue_inputs(dev, dtype, H, Cin, Cout, stride, exp, B, 41 + i)
            with pm.using(None):
                want = glue_block(x, leaves, stride, has)
            r = {"clean": glue_errors(glue_block(x[rows], leaves, stride, has, mesh), want, rows),
                 "hits": {}}
            for site in GLUE_FAULTS:
                if site == "bn1" and not has:
                    continue
                with planted_fault(site) as hits:
                    r[site] = glue_errors(glue_block(x[rows], leaves, stride, has, mesh),
                                          want, rows)
                r["hits"][site] = hits["hits"]
            res[f"{str(dtype)[6:]} {H}x{H} {Cin}->{Cout} s{stride} e{exp}"] = r
            del x, leaves, want
            torch.cuda.empty_cache()
    return res


def hold_glue(glue: list) -> dict:
    """Hold every rank's glue_check: clean, each reading within
    GLUE_LIMITS; each planted fault (which must have been planted) past
    them in at least one reading, so the check would see it. Logs every
    reading, then raises on all misses at once. Returns the worst clean
    readings and, per fault, the smallest of its worst reading over its
    limit."""
    worst_clean, fault_least, misses = {}, {}, []
    for rank, res in enumerate(glue):
        for key, r in res.items():
            log(f"[parallel b glue rank {rank}] {key}: {json.dumps(r)}")
            lim = GLUE_LIMITS[torch.float32 if key.startswith("float32") else torch.bfloat16]
            dt = key.split()[0]
            for q, v in r["clean"].items():
                if not v <= lim[q]:
                    misses.append(f"{key}: clean {q} {v:g} > {lim[q]:g}")
                worst_clean[f"{dt} {q}"] = max(worst_clean.get(f"{dt} {q}", 0.0), v)
            for site, n in r["hits"].items():
                over = max(v / lim[q] for q, v in r[site].items())
                if n <= 0 or not over > 1:
                    misses.append(f"{key}: the planted fault {site} ({n} reductions left "
                                  f"out) passed: {r[site]}")
                k = f"{dt} {site}"
                fault_least[k] = min(fault_least.get(k, float("inf")), over)
    if misses:
        raise AssertionError("parallel (b) glue: " + "; ".join(misses))
    return {"worst_clean": worst_clean, "fault_least_times_limit": fault_least}


PARALLEL_PATH = ("scatter_sorted_fwd", "fusion_gate", "scatter_sorted_bwd", "kd_feature_mse")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_trainer(dev, dtype, fused: bool, part: str = "tp", mesh=None, fused_teacher=False):
    """The KD trainer of train_config at the global batch TRAIN_B (the
    in-loop teacher), on `mesh` when given; its teacher with fused_inference
    blocks (K3) when `fused_teacher`."""
    import dataclasses

    from lmsu_tpu_torch.training import DistillationTrainer
    cfg = train_config(dtype, True, TRAIN_B, fused_train=fused, kd={"teacher_partition": part})
    tcfg = teacher_for(cfg)
    if fused_teacher:
        tcfg = tcfg.replace(camera=dataclasses.replace(tcfg.camera, fused_inference=True))
    return DistillationTrainer(cfg, [None], [None], device=dev, mesh=mesh,
                               teacher_model_config=tcfg)


_REFS: dict = {}


def one_process_refs(dev, dtype, fused: bool, batch_size: int):
    """The one-process reference of the parallel checks, made once per
    (dtype, fused_train, batch): parallel_steps of parallel_trainer over
    train_batch(rng 21) at `batch_size`, from the seeded weights and from
    them moved by 1e-6 (the spread)."""
    key = (str(dtype), fused, batch_size)
    if key not in _REFS:
        batch = train_batch(np.random.default_rng(21), batch_size, dev)
        _REFS[key] = [parallel_steps(parallel_trainer(dev, dtype, fused), batch, perturb=p)
                      for p in (0.0, 1e-6)]
        del batch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return _REFS[key]


def parallel_steps(tr, batch, steps: int = PARALLEL_STEPS, perturb: float = 0.0, mesh=None):
    """`steps` train steps on `batch` (this rank's rows under a mesh): the
    global loss of each, synchronised wall ms of each, the first step's
    (loss, gradients, BN running statistics) as kd_step returns them, the
    collectives a step and their host seconds over the steps after the
    first (whose time is cuDNN's algorithm search), and the parameters' and
    buffers' fingerprints after the steps."""
    from lmsu_tpu_torch.parallel.mesh import all_reduce_
    if perturb:
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in tr.params.values():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(p.device))
    if mesh is not None:
        mesh.reset_counts()
    out = {"losses": [], "step_ms": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(batch)
        if mesh is not None:
            # The global loss: each rank's share summed over the data axis.
            loss = all_reduce_(loss.detach().clone(), mesh=mesh.data_axis())
        out["losses"].append(float(loss))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["step0"] = (out["losses"][0],
                            {k: p.grad.detach().double().cpu() for k, p in tr.params.items()},
                            {k: v.detach().double().cpu() for k, v in tr.model.state_dict().items()
                             if k.endswith(("running_mean", "running_var"))})
            if mesh is not None:
                mesh.reset_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if mesh is not None and steps > 1:
        axes = mesh.axis_counts()
        tot = {k: sum(a[k] for a in axes.values()) for k in ("calls", "seconds", "bytes")}
        out["collectives_per_step"] = tot["calls"] / (steps - 1)
        out["collective_host_s_per_step"] = tot["seconds"] / (steps - 1)
        out["collective_bytes_per_step"] = tot["bytes"] / (steps - 1)
        out["collectives_per_step_by_axis"] = {
            k: {"calls": a["calls"] / (steps - 1), "mb": a["bytes"] / (steps - 1) / 1e6,
                "host_ms": a["seconds"] / (steps - 1) * 1e3} for k, a in axes.items()}
    out["params"] = fingerprint(list(tr.params.values())).cpu().tolist()
    out["buffers"] = fingerprint(list(tr.model.buffers())).cpu().tolist()
    return out


def parallel_world1(dev) -> dict:
    """(a) The f32 in-loop KD step of weighted/128 with its 2x teacher at
    B=128 (sorted_pallas, the fused gate, K7, fused_train) on a world-1 NCCL
    mesh made by make_mesh against the same step without a mesh, three
    steps each from the same seeds, deterministic cuDNN. No collective may
    be issued and K1, K2, K5, K7, K8-K13 must launch. The step is not
    repeatable bit for bit on the card (the FPN's bilinear resize has no
    deterministic CUDA backward: atomicAdd), so a second run without a mesh
    measures the repeat: the first step's loss and BN running statistics
    (forward only) must equal the plain step's bit for bit when the repeat
    does, and its gradients are held by hold_step with the repeat as the
    spread; the three steps' parameters are compared bit for bit and
    reported beside the repeat's."""
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.parallel import mesh as pm
    batch = train_batch(np.random.default_rng(21), TRAIN_B, dev)
    with deterministic_cudnn():
        base = parallel_steps(parallel_trainer(dev, torch.float32, True), batch)
        mesh = pm.make_mesh(backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1, device=dev)
        try:
            reset_launch_counts()
            got = parallel_steps(parallel_trainer(dev, torch.float32, True, mesh=mesh), batch,
                                 mesh=mesh)
            launches = {k: v.launches for k, v in kernels().items() if v.launches}
            calls = mesh.counts["calls"]
        finally:
            pm.destroy(mesh)
        again = parallel_steps(parallel_trainer(dev, torch.float32, True), batch)

    def forward_equal(a, b):
        return a["step0"][0] == b["step0"][0] and all(
            torch.equal(a["step0"][2][k], b["step0"][2][k]) for k in b["step0"][2])
    out = {"backend": mesh.backend, "world_size": mesh.world_size, "collectives": calls,
           "first_step_forward_bit_equal": forward_equal(got, base),
           "plain_first_step_forward_repeats": forward_equal(again, base),
           "three_steps_bit_equal": {k: got[k] == base[k] for k in ("losses", "params",
                                                                    "buffers")},
           "plain_three_steps_repeat": {k: again[k] == base[k] for k in ("losses", "params",
                                                                        "buffers")},
           "losses": got["losses"], "losses_no_mesh": base["losses"],
           "step_ms_mesh": got["step_ms"], "step_ms_no_mesh": base["step_ms"],
           "step_ms_no_mesh_again": again["step_ms"], "launches": launches}
    need = PARALLEL_PATH + IR_TRAIN_KERNELS
    if (calls or any(launches.get(k, 0) <= 0 for k in need)
            or (out["plain_first_step_forward_repeats"]
                and not out["first_step_forward_bit_equal"])):
        raise AssertionError(f"parallel (a) world-1 NCCL step != the plain step: {out}")
    out["held_first_step"] = hold_step("parallel (a) world-1 NCCL step vs the plain step",
                                       got["step0"], base["step0"], noise=again["step0"])
    return out


def parallel_rank(rank: int, world: int, init: str, out_dir: str, device: str) -> None:
    """One rank of (b): the fused blocks' glue check, then every
    PARALLEL_RUNS run on this rank's rows of the global batch, over gloo on
    the one card (`device`); writes rank<r>.json (and, rank 0, each run's
    first step to <run>.pt)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.parallel import mesh as pm
    pin_f32_precision()
    dev = torch.device(device)
    mesh = pm.make_mesh(backend="gloo", init_method=init, rank=rank, world_size=world,
                        device=dev, timeout_s=120)
    t0 = time.perf_counter()
    res = {"glue": glue_check(dev, mesh), "runs": {}}
    res["glue_seconds"] = time.perf_counter() - t0
    L = TRAIN_B // world
    batch = {k: v[rank * L:(rank + 1) * L]
             for k, v in train_batch(np.random.default_rng(21), TRAIN_B, dev).items()}
    for name, dtype, fused, part in PARALLEL_RUNS:
        tr = parallel_trainer(dev, dtype, fused, part, mesh=mesh)
        reset_launch_counts()
        with planted_fault(name.split("_fault_")[1] if "_fault_" in name else None) as hits:
            r = parallel_steps(tr, batch, mesh=mesh)
        r["fault_hits"] = hits["hits"]
        r["launches"] = {k: v.launches for k, v in kernels().items() if v.launches}
        if tr.teacher_shards is not None:
            r["teacher_bytes_per_rank"] = tr.teacher_shards.bytes_per_rank
            r["teacher_bytes_full"] = tr.teacher_shards.bytes_full
        if rank == 0:
            torch.save(r["step0"], os.path.join(out_dir, f"{name}.pt"))
        del r["step0"]
        res["runs"][name] = r
        del tr
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pm.destroy(mesh)


def parallel_gloo(dev, world: int = 2, timeout: float = 420.0) -> dict:
    """(b) `world` ranks over gloo on the one card (NCCL refuses two ranks
    on one GPU), B=TRAIN_B/world each, started after this process has built
    every kernel: each PARALLEL_RUNS run three steps against the
    one-process B=TRAIN_B steps, from the same seeds and batch. f32: the
    first step held by hold_step with the one-process step's spread under a
    1e-6 weight perturbation (loss, every gradient, every BN statistic), the
    later steps' losses to 1e-5 |loss| + min(10 N, 1e-3 |loss|), N the
    one-process loss's own spread under that perturbation at that step
    (hold_step caps 10 N at 1e-4 |loss| for one step; after AdamW steps the
    reference's own spread is past that: 5.6e-4 of the loss at the third
    f32 step on an H100). bf16, whose own rounding moves a step far more
    than that spread: the first step held to the f32 one-process step as
    the one-process bf16 step is (`hold_gap`: each distance at most twice
    the one-process bf16 step's, plus a fixed margin), the later steps'
    losses to the one-process bf16 step's within 1e-5 |loss| + min(10 N,
    1e-2 |loss|), N its own spread under the 1e-6 perturbation at that step
    (1e-2: about two and a half of bf16's units of rounding, 2^-8). The
    ranks' parameters and buffers equal bit for bit; the path's kernels
    launched on each rank; the collectives a step and their share of the
    step's host time, the step ms against the one-process step's. A rank
    that fails, hangs or exits non-zero fails the run.

    That step check is loose for the glue between the fused blocks'
    kernels (its limits follow the one-process step's own spread), so each
    rank first runs glue_check, held here by hold_glue to GLUE_LIMITS; and
    the f32_fused_fault_r2 run, with K11's r2 sums left local on each
    rank, records what the step check reads of such a fault."""
    import tempfile

    from lmsu_tpu_torch.parallel.mesh import run_ranks
    refs = {name: one_process_refs(dev, dtype, fused, TRAIN_B)
            for name, dtype, fused, part in PARALLEL_RUNS if run_name(name) == name}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        logs, _ = run_ranks(
            [[sys.executable, "-c", f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
              f"chip_smoke.parallel_rank({r}, {world}, {init!r}, {d!r}, {str(dev)!r})"]
             for r in range(world)], timeout, cwd=root)
        for line in logs[0].splitlines():
            if line.startswith("fsdp teacher"):
                log(f"[parallel b rank 0] {line}")
        ranks = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
        step0 = {name: torch.load(os.path.join(d, f"{name}.pt"), weights_only=False)
                 for name, *_ in PARALLEL_RUNS}
    out = {"world": world, "per_rank_batch": TRAIN_B // world, "runs": {},
           "glue": hold_glue([r["glue"] for r in ranks]),
           "glue_seconds": max(r["glue_seconds"] for r in ranks)}
    log(f"[parallel b glue] {json.dumps(out['glue'])}")
    for name, dtype, fused, part in PARALLEL_RUNS:
        ref, pert = refs[run_name(name)]
        got = [r["runs"][name] for r in ranks]
        what = f"parallel (b) {name}: {world} ranks vs one process"
        fault = "_fault_" in name
        try:
            if dtype == torch.float32:
                held = hold_step(what, step0[name], ref["step0"], noise=pert["step0"])
            else:
                anchor = refs[name.replace("bf16", "f32")][0]
                held = hold_gap(what, step0[name], ref["step0"], anchor["step0"])
            cap = 1e-3 if dtype == torch.float32 else 1e-2
            held["later_losses"] = []
            for i in range(1, PARALLEL_STEPS):
                la, lb, lp = got[0]["losses"][i], ref["losses"][i], pert["losses"][i]
                held["later_losses"].append({"err": abs(la - lb), "spread": abs(lp - lb)})
                if not abs(la - lb) <= 1e-5 * abs(lb) + min(10 * abs(lp - lb), cap * abs(lb)):
                    raise AssertionError(f"{what}: step {i} loss {la} != {lb} (perturbed {lp})")
        except AssertionError as e:
            if not fault:
                raise
            held = {"failed": str(e)[:400]}
        if fault:
            # The step check's reading of a planted fault: recorded, not held.
            held["fault_hits"] = [g["fault_hits"] for g in got]
            held["distance"] = step_distance(step0[name], ref["step0"])
            held["one_process_spread"] = step_distance(pert["step0"], ref["step0"])
            if min(held["fault_hits"]) <= 0:
                raise AssertionError(f"{what}: the fault was not planted")
        for g in got[1:]:
            if (g["params"], g["buffers"], g["losses"]) != (
                    got[0]["params"], got[0]["buffers"], got[0]["losses"]):
                raise AssertionError(f"parallel (b) {name}: the ranks' parameters differ")
        need = PARALLEL_PATH + (IR_TRAIN_KERNELS if fused else ())
        for g in got:
            if any(g["launches"].get(k, 0) <= 0 for k in need):
                raise AssertionError(f"parallel (b) {name}: launches {g['launches']}")
        r0 = got[0]
        wall = float(np.median(r0["step_ms"][1:]))
        run = {"losses": r0["losses"], "losses_one_process": ref["losses"],
               "step_ms": r0["step_ms"], "step_ms_one_process": ref["step_ms"],
               "step_ms_median_after_first": wall,
               "step_ms_one_process_median_after_first": float(np.median(ref["step_ms"][1:])),
               "collectives_per_step": r0["collectives_per_step"],
               "collective_host_ms_per_step": r0["collective_host_s_per_step"] * 1e3,
               "collective_share_of_step": (r0["collective_host_s_per_step"] * 1e3
                                            / float(np.mean(r0["step_ms"][1:]))),
               "collective_mb_per_step": r0["collective_bytes_per_step"] / 1e6,
               "launches_rank0": r0["launches"], "held_step0": held}
        if part == "fsdp":
            run.update({k: r0[k] for k in ("teacher_bytes_per_rank", "teacher_bytes_full")})
            if not r0["teacher_bytes_per_rank"] < 0.55 * r0["teacher_bytes_full"]:
                raise AssertionError(f"parallel (b) fsdp: teacher bytes {run}")
        out["runs"][name] = run
        log(f"[parallel b {name}] {json.dumps(run)}")
    return out


def step_distance(a, b) -> dict:
    """How far step `a` is from step `b` (each as kd_step returns it): the
    loss's absolute difference, the gradients' relative L2 difference, the
    largest BN statistic difference over its tensor's scale."""
    (la, ga, sa), (lb, gb, sb) = a, b
    norm = sum((g ** 2).sum().item() for g in gb.values()) ** 0.5
    return {"loss": abs(la - lb),
            "grad_rel_l2": sum(((ga[k] - gb[k]) ** 2).sum().item() for k in gb) ** 0.5 / norm,
            "bn_stat_rel": max(((sa[k] - sb[k]).abs().max() / sb[k].abs().max().clamp(min=1e-12))
                               .item() for k in sb)}


def hold_gap(what, got, want, anchor) -> dict:
    """Hold a bf16 step `got` as its one-process counterpart `want` stands to
    the f32 one-process step `anchor` (each as kd_step returns it): each
    distance of got's from the anchor (step_distance) at most twice want's
    plus a fixed margin (1e-5 of the loss, 1e-3 relative L2, 1e-4 of a
    statistic's scale)."""
    d_got, d_want = step_distance(got, anchor), step_distance(want, anchor)
    fixed = {"loss": 1e-5 * abs(anchor[0]), "grad_rel_l2": 1e-3, "bn_stat_rel": 1e-4}
    for k, v in d_got.items():
        if not v <= 2 * d_want[k] + fixed[k]:
            raise AssertionError(f"{what}: {k} {v:g} from f32 > 2 x {d_want[k]:g} + {fixed[k]:g}")
    return {"got_from_f32": d_got, "one_process_from_f32": d_want}


def parallel_serving(dev, child) -> dict:
    """(c) ServingEngine.from_predictor(devices=[the card]) against the
    plain engine on the same Predictor: B=8 f32 weighted/128 with its
    kernels, the same 16 frames through both, bit for bit; K1-K3 launched
    on the data-parallel engine's run. Then the `serve --data-parallel 1`
    child (started by the caller) answers one HTTP request within 1e-4 of
    scale of the same seeded Predictor."""
    from lmsu_tpu_torch import serve
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.serving import ServingEngine
    pred = Predictor(serving_config(torch.float32), device=dev, seed=0)
    randomize_bn(pred.model, 1)
    frames = make_frames(np.random.default_rng(17), 16)
    outs, launches = {}, None
    for name, devices in (("plain", None), ("devices", [dev])):
        eng = ServingEngine.from_predictor(pred, batch_size=B, image_size=(IMG, IMG),
                                           num_points=NPTS, max_delay_ms=5.0, devices=devices)
        try:
            eng.warmup()
            reset_launch_counts()
            outs[name] = np.stack([f.result(timeout=300) for f in
                                   [eng.submit(img, pts) for img, pts in frames]])
            if devices is not None:
                launches = {k: v.launches for k, v in kernels().items() if v.launches}
        finally:
            eng.close()
    if not np.array_equal(outs["plain"], outs["devices"]) or any(
            launches.get(k, 0) <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"parallel (c): devices=[{dev}] != the plain engine "
                             f"({float(np.abs(outs['plain'] - outs['devices']).max())}), "
                             f"launches {launches}")
    args = serve.parse_args(["--device", "cuda", "--seed", "0"])
    eng = ServingEngine.from_predictor(Predictor(serve.build_config(args), device=dev, seed=0),
                                       batch_size=B, image_size=(IMG, IMG), num_points=NPTS)
    try:
        direct = [eng.predict(*frames[0], timeout=300)]
    finally:
        eng.close()
    served = finish_artifact_child(*child, frames[:1], direct, what="serve --data-parallel 1")
    return {"frames": len(frames), "bit_equal": True, "launches": launches,
            "data_parallel_1_child": served}


def parallel_multiprocess(timeout: float = 420.0, while_running=None):
    """(d) `python -m lmsu_tpu_torch.run_multiprocess --device cuda
    --num-processes 2` (gloo on the one card): it must exit 0 and print its
    summary. `while_running()`, when given, runs in this process meanwhile.
    Returns (the summary, while_running's result)."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as out:
        proc = subprocess.Popen([sys.executable, "-m", "lmsu_tpu_torch.run_multiprocess",
                                 "--device", "cuda", "--num-processes", "2", "--timeout",
                                 str(timeout - 60)], cwd=root, stdout=out,
                                stderr=subprocess.STDOUT, text=True)
        try:
            extra = while_running() if while_running is not None else None
            proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        text = out.read()
    if proc.returncode != 0 or "OK" not in text:
        raise AssertionError(f"run_multiprocess exited {proc.returncode}:\n{text[-3000:]}")
    summary = json.loads(text[text.index("{", text.index("OK")):])
    summary["seconds"] = time.perf_counter() - t0
    return summary, extra


# -- the model axis: the tp and sp teachers on a 2-D (data, model) mesh ----------

# The teacher check's limit in f32: each output's largest difference from
# the one-process teacher's over that output's largest magnitude.
TEACHER_LIMIT_F32 = 1e-5
# The model-axis runs of (e): (dtype name, dtype); tp then sp in each.
MODEL_AXIS_DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))
# The rows of (e)'s batch that the planted faults and the fused_inference
# teacher run on: each tp forward of B=128 moves ~5 GB a rank through
# gloo's host staging on the one card (~10 s), and these checks read a
# scale-relative distance that does not need the whole batch.
MODEL_AXIS_SUB_ROWS = 32


@contextlib.contextmanager
def planted_split_fault(part: str):
    """Plant one fault in the split teacher's next forward (parallel/tp.py):
    "tp" feeds its first contraction over a split activation (the first
    gather) this rank's channel slice with zeros for the other ranks'
    channels, as if the gather were left out; "sp" fills its first halo
    exchange with zero rows. Yields a dict whose "hits" counts them."""
    from lmsu_tpu_torch.parallel import tp as ptp
    hits = {"hits": 0}
    if part == "tp":
        cls, name = ptp.TensorParallelTeacher, "whole"

        def faulty(self, a):
            if not a.split or hits["hits"]:
                return real(self, a)
            hits["hits"] += 1
            parts = [torch.zeros_like(a.t)] * self.mm.world_size
            parts[self.mm.rank] = a.t
            return torch.cat(parts, 1)
    else:
        cls, name = ptp.SpatialTeacher, "halo"

        def faulty(self, x, below):
            top, bottom = real(self, x, below)
            if hits["hits"]:
                return top, bottom
            hits["hits"] += 1
            return torch.zeros_like(top), None if bottom is None else torch.zeros_like(bottom)
    real = getattr(cls, name)
    setattr(cls, name, faulty)
    try:
        yield hits
    finally:
        setattr(cls, name, real)


def teacher_outputs(tr, batch) -> dict:
    """A KD trainer's teacher on `batch`: its logits and its taps (all whole)."""
    with torch.no_grad():
        logits, taps = tr.teacher(batch["image"], batch["points"], batch.get("point_valid"),
                                  return_intermediates=True)
    return {"logits": logits, **{k: v for k, v in taps.items() if k != "logits"}}


def scale_errs(got: dict, want: dict) -> dict:
    """Each output's largest difference over want's largest magnitude."""
    return {k: ((got[k].double() - want[k].double()).abs().max()
                / want[k].double().abs().max().clamp(min=1e-30)).item() for k in want}


class first_call:
    """Hooks on `teacher` that keep its first call's outputs (as
    teacher_outputs gives them), its peak device bytes above what it started
    on, the collectives it made by axis and its gathers, in `seen`;
    close() removes them."""

    def __init__(self, teacher, mesh):
        self.seen = {}

        def pre(mod, args):
            if not self.seen:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                self.seen.update(base=torch.cuda.memory_allocated(), counts=mesh.axis_counts())

        def post(mod, args, out):
            if "out" in self.seen:
                return
            torch.cuda.synchronize()
            after = mesh.axis_counts()
            self.seen.update(
                out={"logits": out[0], **{k: v for k, v in out[1].items() if k != "logits"}},
                peak=torch.cuda.max_memory_allocated() - self.seen["base"],
                collectives={a: {k: after[a][k] - self.seen["counts"][a][k] for k in after[a]}
                             for a in after},
                gathers=mod.gathers)
        self.handles = [teacher.register_forward_pre_hook(pre),
                        teacher.register_forward_hook(post)]

    def close(self):
        for h in self.handles:
            h.remove()


def forward_peak(tr, batch):
    """(outputs, the forward's peak device bytes above what it started on)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = teacher_outputs(tr, batch)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def params_sha256(tr) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in list(tr.params.values()) + list(tr.model.buffers()):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def model_axis_rank(rank: int, world: int, mp: int, init: str, out_dir: str, device: str,
                    batch_size: int, plan: str) -> None:
    """One rank of the (data world/mp, model mp) mesh over gloo on the one
    card, this rank's data stripe of train_batch(rng 21) at `batch_size`.
    plan "e": tp, then sp, f32 then bf16: three KD steps, and the teacher
    check on the first step's teacher call (each output against the
    one-process teacher on the same rows, and in bf16 the one-process f32
    teacher too; each planted fault in f32, a forward of its own); then the
    fused_inference teacher (K3) split both ways; plan "f": one KD step of
    tp and one of sp (f32). Writes rank<r>.json
    and, rank 0, each run's first step to <run>.pt."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    from lmsu_tpu_torch.parallel import mesh as pm
    pin_f32_precision()
    dev = torch.device(device)
    mesh = pm.make_mesh(MeshConfig(model_parallel=mp), backend="gloo", init_method=init,
                        rank=rank, world_size=world, device=dev, timeout_s=300)
    L = batch_size // mesh.data_size
    batch = {k: v[mesh.data_rank * L:(mesh.data_rank + 1) * L]
             for k, v in train_batch(np.random.default_rng(21), batch_size, dev).items()}
    sub = {k: v[:MODEL_AXIS_SUB_ROWS] for k, v in batch.items()}
    res = {"teacher": {}, "runs": {}}
    t0 = time.perf_counter()

    def kd_run(name, tr, steps):
        """`steps` KD steps of `tr` on this rank's rows, its launches counted."""
        reset_launch_counts()
        r = parallel_steps(tr, batch, steps=steps, mesh=mesh)
        r["launches"] = {k: v.launches for k, v in kernels().items() if v.launches}
        r["sha256"] = params_sha256(tr)
        r["layout"] = tr.teacher_layout
        if rank == 0:
            torch.save(r["step0"], os.path.join(out_dir, f"{name}.pt"))
        del r["step0"]
        res["runs"][name] = r

    if plan == "f":
        for part in ("tp", "sp"):
            kd_run(f"f32_{part}", parallel_trainer(dev, torch.float32, True, part, mesh=mesh), 1)
            torch.cuda.empty_cache()
    else:
        anchor = None
        for dt, dtype in MODEL_AXIS_DTYPES:
            with pm.using(None):
                whole, whole_peak = forward_peak(parallel_trainer(dev, dtype, True), batch)
            gap = None if anchor is None else scale_errs(whole, anchor)
            for part in ("tp", "sp"):
                tr = parallel_trainer(dev, dtype, True, part, mesh=mesh)
                # The KD steps; the teacher check reads the first step's
                # teacher call (its outputs, peak bytes and collectives).
                first = first_call(tr.teacher, mesh)
                kd_run(f"{dt}_{part}", tr, PARALLEL_STEPS)
                first.close()
                t1 = time.perf_counter()
                got = first.seen.pop("out")
                sh = tr.teacher_shards
                r = {"errs": scale_errs(got, whole), "layout": tr.teacher_layout,
                     "collectives": first.seen["collectives"],
                     "peak_forward_bytes": first.seen["peak"],
                     "peak_forward_bytes_whole": whole_peak, "gathers": first.seen["gathers"]}
                if part == "tp":
                    r.update(bytes_per_rank=sh.bytes_per_rank, bytes_full=sh.bytes_full)
                else:
                    r["halos"] = sh.halos
                if gap is not None:
                    r["errs_from_f32"] = scale_errs(got, anchor)
                    r["whole_gap_from_f32"] = gap
                del got
                if dt == "f32":
                    # Each planted fault (planted_split_fault), f32, on the
                    # first MODEL_AXIS_SUB_ROWS rows.
                    with planted_split_fault(part) as hits:
                        r["fault_errs"] = scale_errs(
                            teacher_outputs(tr, sub), {k: v[:len(sub["image"])]
                                                       for k, v in whole.items()})
                    r["fault_hits"] = hits["hits"]
                r["seconds"] = time.perf_counter() - t1
                res["teacher"][f"{dt}_{part}"] = r
                del tr
                torch.cuda.empty_cache()
            if anchor is None:
                anchor = whole
            else:
                del whole
        del anchor
        # K3 under both splits: the teacher with fused_inference blocks (f32),
        # on the first MODEL_AXIS_SUB_ROWS rows.
        with pm.using(None):
            whole = teacher_outputs(parallel_trainer(dev, torch.float32, True,
                                                     fused_teacher=True), sub)
        for part in ("tp", "sp"):
            tr = parallel_trainer(dev, torch.float32, True, part, mesh=mesh, fused_teacher=True)
            reset_launch_counts()
            got = teacher_outputs(tr, sub)
            res["teacher"][f"f32_fused_inference_{part}"] = {
                "errs": scale_errs(got, whole),
                "launches": {k: v.launches for k, v in kernels().items() if v.launches}}
            del tr, got
        del whole
        torch.cuda.empty_cache()
        res["teacher_seconds"] = sum(r.get("seconds", 0.0) for r in res["teacher"].values())
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pm.destroy(mesh)


def launch_model_axis(dev, world: int, mp: int, batch_size: int, plan: str,
                      timeout: float = 600.0):
    """Run model_axis_rank on `world` processes over gloo on the card:
    (each rank's JSON, each run's first step from rank 0)."""
    import tempfile

    from lmsu_tpu_torch.parallel.mesh import run_ranks
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        logs, _ = run_ranks(
            [[sys.executable, "-c", f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
              f"chip_smoke.model_axis_rank({r}, {world}, {mp}, {init!r}, {d!r}, {str(dev)!r}, "
              f"{batch_size}, {plan!r})"] for r in range(world)], timeout, cwd=root)
        for line in logs[0].splitlines():
            if line.startswith(("tp teacher", "fsdp teacher")):
                log(f"[parallel {plan} rank 0] {line}")
        ranks = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
        step0 = {name: torch.load(os.path.join(d, f"{name}.pt"), weights_only=False)
                 for name in ranks[0]["runs"]}
    return ranks, step0


def hold_teacher(ranks) -> dict:
    """(e)'s teacher check on every rank: f32 each output within
    TEACHER_LIMIT_F32 of scale of the one-process teacher's; bf16 each
    output's distance from the one-process f32 teacher at most twice the
    one-process bf16 teacher's own; the fused_inference teacher in f32 as
    f32, K3 launched; each planted fault past the f32 limit by at least
    100x in some output. Returns the worst readings; raises on any miss."""
    out, misses = {}, []
    for rank, res in enumerate(ranks):
        for key, r in res["teacher"].items():
            log(f"[parallel e teacher rank {rank}] {key}: {json.dumps(r)}")
            if key.startswith("bf16"):
                worst = max(r["errs_from_f32"][k] / max(2 * r["whole_gap_from_f32"][k], 1e-30)
                            for k in r["errs"])
                ok = worst <= 1
            else:
                worst = max(r["errs"].values()) / TEACHER_LIMIT_F32
                ok = worst <= 1
            if "fused_inference" in key and r["launches"].get("ir_fused_infer", 0) <= 0:
                misses.append(f"{key}: K3 did not launch")
            if not ok:
                misses.append(f"{key} rank {rank}: {worst:g} x its limit: {r['errs']}")
            out[key] = max(out.get(key, 0.0), worst)
            if "fault_errs" in r:
                over = max(r["fault_errs"].values()) / TEACHER_LIMIT_F32
                out[f"{key}_fault"] = min(out.get(f"{key}_fault", float("inf")), over)
                if r["fault_hits"] != 1:
                    misses.append(f"{key} rank {rank}: the fault was planted "
                                  f"{r['fault_hits']} times, not once")
                if not over >= 100:
                    misses.append(f"{key} rank {rank}: the planted fault reads only {over:g} x "
                                  "the limit")
    if misses:
        raise AssertionError("parallel (e) teacher: " + "; ".join(misses))
    return {"worst_over_limit": {k: v for k, v in out.items() if not k.endswith("_fault")},
            "fault_least_over_limit": {k: v for k, v in out.items() if k.endswith("_fault")}}


def hold_model_axis_steps(what, ranks, step0, refs, need) -> dict:
    """The KD runs of the model-axis ranks against the one-process steps
    (`refs`: {dtype name: [plain, perturbed]} at the global batch): f32
    first steps by hold_step with the spread, bf16 by hold_gap against the
    f32 reference, the later losses as parallel_gloo holds them; every
    rank's parameters and buffers equal (sha256) and the path's kernels
    launched on each rank."""
    out = {}
    for name in ranks[0]["runs"]:
        dt = name.split("_")[0]
        ref, pert = refs[dt]
        got = [r["runs"][name] for r in ranks]
        w = f"{what} {name}"
        if dt == "f32":
            held = hold_step(w, step0[name], ref["step0"], noise=pert["step0"])
        else:
            held = hold_gap(w, step0[name], ref["step0"], refs["f32"][0]["step0"])
        cap = 1e-3 if dt == "f32" else 1e-2
        held["later_losses"] = []
        for i in range(1, len(got[0]["losses"])):
            la, lb, lp = got[0]["losses"][i], ref["losses"][i], pert["losses"][i]
            held["later_losses"].append({"err": abs(la - lb), "spread": abs(lp - lb)})
            if not abs(la - lb) <= 1e-5 * abs(lb) + min(10 * abs(lp - lb), cap * abs(lb)):
                raise AssertionError(f"{w}: step {i} loss {la} != {lb} (perturbed {lp})")
        shas = [g["sha256"] for g in got]
        if len(set(shas)) != 1:
            raise AssertionError(f"{w}: the ranks' parameters differ: {shas}")
        for g in got:
            if g["layout"] != name.split("_")[1] or any(
                    g["launches"].get(k, 0) <= 0 for k in need):
                raise AssertionError(f"{w}: layout {g['layout']}, launches {g['launches']}")
        r0 = got[0]
        steps_ms = r0["step_ms"][1:] or r0["step_ms"]
        ref_ms = ref["step_ms"][1:] or ref["step_ms"]
        run = {"losses": r0["losses"], "losses_one_process": ref["losses"][:len(r0["losses"])],
               "sha256_ranks": shas, "step_ms": r0["step_ms"],
               "step_ms_one_process": ref["step_ms"],
               "step_ms_median": float(np.median(steps_ms)),
               "step_ms_one_process_median": float(np.median(ref_ms)),
               "collectives_per_step_by_axis": r0.get("collectives_per_step_by_axis"),
               "peak_gb_rank0": r0["peak_bytes"] / 1e9, "launches_rank0": r0["launches"],
               "held_step0": held}
        out[name] = run
        log(f"[{what} {name}] {json.dumps({k: v for k, v in run.items() if k != 'held_step0'})}")
    return out


def parallel_model_axis_e(dev) -> dict:
    """(e) two gloo ranks on the card as a (data 1, model 2) mesh: weighted/128
    and its 2x teacher at full width on the KD path (sorted_pallas, the fused
    gate, K7, fused_train), the teacher split by channel (tp) and by image
    rows (sp), f32 and bf16: the teacher check (hold_teacher) on the first
    KD step's teacher call and three KD steps against the one-process steps
    over the same rows; each rank takes the whole batch, B=128 when two of
    the one-process step's peaks fit on the card with 8 GB to spare, else 64
    (the planted faults and the fused_inference teacher on its first
    MODEL_AXIS_SUB_ROWS rows)."""
    t0 = time.perf_counter()
    ref128 = one_process_refs(dev, torch.float32, True, TRAIN_B)
    total = torch.cuda.get_device_properties(dev).total_memory
    B_e = TRAIN_B if 2 * ref128[0]["peak_bytes"] + 8e9 < total else TRAIN_B // 2
    log(f"[parallel e] B={B_e} a rank (the one-process B={TRAIN_B} step's peak "
        f"{ref128[0]['peak_bytes'] / 1e9:.2f} GB, the card {total / 1e9:.2f} GB)")
    refs = {dt: one_process_refs(dev, dtype, True, B_e) for dt, dtype in MODEL_AXIS_DTYPES}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks, step0 = launch_model_axis(dev, 2, 2, B_e, "e")
    out = {"batch_per_rank": B_e, "teacher": hold_teacher(ranks),
           "teacher_seconds": max(r["teacher_seconds"] for r in ranks),
           "rank_seconds": max(r["seconds"] for r in ranks),
           "runs": hold_model_axis_steps("parallel e", ranks, step0, refs,
                                         PARALLEL_PATH + IR_TRAIN_KERNELS)}
    t = ranks[0]["teacher"]
    out["teacher_bytes"] = {"tp_per_rank": t["f32_tp"]["bytes_per_rank"],
                            "whole": t["f32_tp"]["bytes_full"]}
    out["peak_forward_bytes"] = {
        k: {"split": t[k]["peak_forward_bytes"], "whole": t[k]["peak_forward_bytes_whole"]}
        for k in ("f32_tp", "f32_sp", "bf16_tp", "bf16_sp")}
    out["teacher_collectives"] = {k: t[k]["collectives"] for k in ("f32_tp", "f32_sp")}
    out["gathers_per_forward"] = {k: t[k]["gathers"] for k in ("f32_tp", "f32_sp")}
    out["seconds"] = time.perf_counter() - t0
    log(f"[parallel e] {json.dumps({k: v for k, v in out.items() if k != 'runs'})}")
    return out


def parallel_model_axis_f(dev) -> dict:
    """(f) four gloo ranks on the card as a (data 2, model 2) mesh, one tp
    and one sp KD step (f32) at the global B=16 against one process (a
    first step each: its time holds cuDNN's algorithm search)."""
    t0 = time.perf_counter()
    refs16 = {"f32": one_process_refs(dev, torch.float32, True, 16)}
    ranks, step0 = launch_model_axis(dev, 4, 2, 16, "f")
    out = {"runs": hold_model_axis_steps("parallel f", ranks, step0, refs16,
                                         PARALLEL_PATH + IR_TRAIN_KERNELS),
           "rank_seconds": max(r["seconds"] for r in ranks),
           "seconds": time.perf_counter() - t0}
    log(f"[parallel f] {out['seconds']:.1f} s")
    return out


def start_serve_child(dev):
    """`python -m lmsu_tpu_torch.serve --data-parallel 1` (weighted/128,
    seed 0, B=8, port 0) in a child process; (c) finishes it."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-u", "-m", "lmsu_tpu_torch.serve", "--device", "cuda", "--seed",
           "0", "--data-parallel", "1", "--batch-size", str(B), "--port", "0", "--image-size",
           str(IMG), str(IMG), "--num-points", str(NPTS), "--max-delay-ms", "5"]
    return (subprocess.Popen(cmd, cwd=root, env=dict(os.environ, PYTHONUNBUFFERED="1"),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def phase_parallel(dev) -> dict:
    """The parallel phase: (a) the world-1 NCCL step, (b) two gloo ranks on
    the card, (e) the model axis on two ranks (parallel_model_axis_e), (c)
    data-parallel serving and `serve --data-parallel 1`, (d)
    `run_multiprocess --device cuda --num-processes 2` and beside it (f) the
    model axis on four ranks (parallel_model_axis_f)."""
    t0 = time.perf_counter()
    child = start_serve_child(dev)
    try:
        res = {"world1_nccl": parallel_world1(dev)}
        log(f"[parallel a] world-1 NCCL step: {json.dumps(res['world1_nccl'])}")
        res["gloo_two_ranks"] = parallel_gloo(dev)
        res["model_axis"] = {"e": parallel_model_axis_e(dev)}
        res["serving"] = parallel_serving(dev, child)
        log(f"[parallel c] {json.dumps(res['serving'])}")
    finally:
        if child[0].poll() is None:
            child[0].kill()
            child[0].wait()
    # (f) runs while (d)'s processes do: both are checks of correctness
    # whose times are first steps and a tiny epoch.
    res["run_multiprocess"], res["model_axis"]["f"] = parallel_multiprocess(
        while_running=lambda: parallel_model_axis_f(dev))
    res["model_axis"]["seconds"] = res["model_axis"]["e"]["seconds"] + \
        res["model_axis"]["f"]["seconds"]
    log(f"[parallel d] run_multiprocess: {json.dumps(res['run_multiprocess'])}")
    res["seconds"] = time.perf_counter() - t0
    log(f"[parallel] phase {res['seconds']:.1f} s")
    return res


# -- experiments phase: the KD experiments and the host tools ---------------

# The tiny regime of every experiment: one epoch (the teacher's too), 64 train
# and 32 val hard synthetic samples at B=32, the published widths.
EXP_TINY = ["--epochs", "1", "--num-train", "64", "--num-val", "32", "--batch-size", "32",
            "--num-workers", "4"]
# The kernel opt-ins: the experiments that build their own configurations take
# the sorted scatter (K1, K5), the gate kernel (K2, weighted fusion) and the
# feature-MSE kernel (K7); the three recipe experiments hand train_distill the
# recipe's pallas scatter (K6) and K7, and the weighted one K2.
EXP_KERNELS = ["--scatter-impl", "sorted_pallas", "--use-pallas-fusion", "--use-pallas-kd"]
EXP_RECIPE = ["--scatter-impl", "pallas", "--use-pallas-kd"]
K_SORTED = ("scatter_sorted_fwd", "fusion_gate", "scatter_sorted_bwd", "kd_feature_mse")
# (experiment, its flags past the tiny regime, the kernels its configuration
# selects, the result JSON's keys), in the order their outputs feed each
# other: kd_lift's teacher and results before kd_sweep and kd_compression,
# kd_crossarch's before crossarch_best, best_overall's before kd_ensemble.
EXPERIMENTS = (
    ("kd_lift", ["--seeds", "0"] + EXP_KERNELS, K_SORTED,
     {"benchmark", "config", "per_seed", "mean_miou", "seed_spread", "kd_gap_per_seed",
      "kd_gap_mean", "kd_gap_min", "kd_lift_every_seed"}),
    ("kd_sweep", ["--seed", "0"] + EXP_KERNELS, K_SORTED,
     {"seed", "benchmark", "baselines", "sweep"}),
    ("kd_cache_equiv", ["--seed", "0"] + EXP_KERNELS, K_SORTED,
     {"seed", "onchip_epoch", "student_kd_inloop", "student_kd_cached", "abs_diff",
      "train_wall_s", "note"}),
    ("kd_compression", ["--seed", "0"] + EXP_KERNELS, K_SORTED,
     {"benchmark", "seed", "teacher", "w1_reference", "sweep"}),
    ("kd_crossarch", ["--seeds", "0"] + EXP_KERNELS, K_SORTED,
     {"benchmark", "experiment", "teacher_lidar_encoder", "student_lidar_encoder", "config",
      "per_seed", "mean_miou", "seed_spread", "kd_gap_per_seed", "kd_gap_mean", "kd_gap_min",
      "kd_lift_every_seed"}),
    ("best_overall", ["--seeds", "0"] + EXP_RECIPE, ("voxelize_scatter_max", "kd_feature_mse"),
     {"benchmark", "config", "per_seed", "mean_student"}),
    ("crossarch_best", ["--seeds", "0", "--use-pallas-fusion"] + EXP_RECIPE,
     ("voxelize_scatter_max", "fusion_gate", "kd_feature_mse"),
     {"benchmark", "experiment", "config", "per_seed", "recipe_gap_mean", "recipe_gap_min",
      "recipe_lift_every_seed", "mean_student"}),
    ("kd_ensemble", ["--seeds", "0"] + EXP_RECIPE, ("voxelize_scatter_max", "kd_feature_mse"),
     {"benchmark", "config", "per_seed", "mean_student_ensemble", "mean_student_single"}),
)


def result_mious(name: str, res: dict) -> list:
    """Every mIoU an experiment's result JSON holds."""
    if name in ("kd_lift", "kd_crossarch", "best_overall", "crossarch_best"):
        return [v for r in res["per_seed"].values() for k, v in r.items()
                if not k.startswith("vs_")]
    if name == "kd_sweep":
        return list(res["sweep"].values()) + list(res["baselines"].values())
    if name == "kd_cache_equiv":
        return [res["student_kd_inloop"], res["student_kd_cached"]]
    if name == "kd_compression":
        return ([v for r in res["sweep"].values() for v in (r["student"], r["student_kd"])]
                + [res["teacher"]["miou"], res["w1_reference"]["student"],
                   res["w1_reference"]["student_kd"]])
    return [v for r in res["per_seed"].values()
            for v in (r["teacher_a"], r["teacher_b"], r["student_ensemble"],
                      r["student_single_teacher_committed"])]


@contextlib.contextmanager
def quiet(what: str):
    """The block's stdout kept, not printed; its tail goes to stderr when the
    block raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    except BaseException:
        sys.stderr.write(f"--- {what}: the end of its output ---\n{buf.getvalue()[-6000:]}\n")
        raise


def run_experiments(dev, root) -> dict:
    """(a) Each KD experiment through its main(argv) at the tiny
    regime (EXP_TINY, seed 0), every output under the output root `root`:
    its result JSON has the experiment's keys, every mIoU in it is finite and in
    [0, 1], and each kernel its configuration selects was launched (counts
    from 0 before each experiment). Seconds and launches per experiment."""
    import importlib

    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    out = {}
    for name, argv, need, keys in EXPERIMENTS:
        mod = importlib.import_module(f"lmsu_tpu_torch.experiments.{name}")
        reset_launch_counts()
        t0 = time.perf_counter()
        with quiet(name):
            res = mod.main(["--device", str(dev), "--output-root", root] + EXP_TINY + argv)
        secs = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels().items() if v.launches}
        mious = [float(v) for v in result_mious(name, res)]
        bad = [k for k in need if launches.get(k, 0) <= 0]
        if (set(res) != keys or not mious
                or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in mious) or bad):
            raise AssertionError(f"experiments {name}: keys {sorted(res)}, mIoU {mious}, "
                                 f"kernels not launched {bad}, launches {launches}")
        out[name] = {"seconds": secs, "mious": mious, "launches": launches}
        log(f"[experiments a] {name}: {json.dumps(out[name])}")
    return out


def check_gate_analysis(dev, root) -> dict:
    """(b) analyze_weighted_gate on kd_lift's weighted/128 student (its
    best.pth under `root`) with the gate kernel K2, end to end; then each of
    the four gate variants on one val batch, K2's path against the plain
    gate's on the card within serving's 1e-3, and the gate's output against
    its weights recomputed in float64 from the captured projections:
    uniform's camera weight exactly 0.5 and the fused map 0.5 (cam + lid),
    camera_only's weight >= 1 - 1e-6 and the fused map the camera's,
    lidar_only's the LiDAR's (each within 1e-5 of scale)."""
    from lmsu_tpu_torch import analyze_weighted_gate as awg
    from lmsu_tpu_torch.common import build_loaders
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.ops._cuda import kernels, reset_launch_counts
    ck = os.path.join(root, "checkpoints", "kd_lift_student_s0", "best.pth")
    argv = ["--device", str(dev), "--output-root", root, "--checkpoint", ck,
            "--num-val", "32", "--batch-size", "32", "--num-workers", "4",
            "--scatter-impl", "sorted_pallas", "--stat-batches", "1"]
    reset_launch_counts()
    with quiet("analyze_weighted_gate"):
        res = awg.main(argv + ["--use-pallas-fusion"])
    out = {"launches": {k: v.launches for k, v in kernels().items() if v.launches},
           "gate_variants_val_miou": {k: v["miou"]
                                      for k, v in res["gate_variants_val_miou"].items()},
           "gate_stats": res["gate_stats"]}
    if out["launches"].get("fusion_gate", 0) <= 0:
        raise AssertionError(f"analyze_weighted_gate: K2 not launched {out['launches']}")
    cfg = awg._regime(awg.make_parser().parse_args(argv))
    weights = load_weights(ck, cfg.model)
    _, val = build_loaders(cfg, verbose=False)
    batch = next(iter(val))
    kpred = Predictor(cfg.model.replace(use_pallas_fusion=True), weights, device=dev)
    ppred = Predictor(cfg.model, weights, device=dev)
    taps = {}
    hooks = [getattr(kpred.model.fusion, n).register_forward_hook(
        lambda m, i, o, n=n: taps.__setitem__(n, o.float())) for n in ("cam_proj", "lidar_proj")]
    hooks.append(kpred.model.fusion.register_forward_hook(
        lambda m, i, o: taps.__setitem__("fused", o[1].float())))
    args = (batch["image"], batch["points"], batch.get("point_valid"))
    try:
        for kind in awg.GATE_KINDS:
            sd = awg._gate_variant(weights, kind)
            kpred.model.load_state_dict(sd)
            ppred.model.load_state_dict(sd)
            reset_launch_counts()
            a = kpred(*args).float()
            k2 = kernels()["fusion_gate"].launches
            cam, lid, fused = taps["cam_proj"], taps["lidar_proj"], taps["fused"]
            b = ppred(*args).float()
            err = float((a - b).abs().max())
            w_cam, _ = awg.gate_weights(kpred, [batch], cfg, 1)
            row = {"k2_launches": k2, "err_k2_vs_plain_path": err,
                   "camera_weight_min": float(w_cam.min()),
                   "camera_weight_max": float(w_cam.max())}
            want = {"uniform": 0.5 * (cam + lid), "camera_only": cam,
                    "lidar_only": lid}.get(kind)
            if want is not None:
                row["fused_err_of_scale"] = float((fused - want).abs().max()
                                                  / want.abs().max().clamp_min(1e-30))
            ok = (k2 > 0 and err <= 1e-3 and row.get("fused_err_of_scale", 0.0) <= 1e-5
                  and {"uniform": (w_cam == 0.5).all(),
                       "camera_only": w_cam.min() >= 1 - 1e-6,
                       "lidar_only": w_cam.max() <= 1e-6}.get(kind, True))
            if not ok:
                raise AssertionError(f"gate variant {kind}: {row}")
            out[kind] = row
    finally:
        for h in hooks:
            h.remove()
    log(f"[experiments b] analyze_weighted_gate: {json.dumps(out)}")
    return out


def check_visualize_compute(dev, root) -> dict:
    """(c) visualize_predictions' compute part for 16 val samples of kd_lift's
    student (B=8): on the card (K1, K2) against the same on the CPU (plain
    versions). The argmax agrees wherever the CPU's margin over the
    runner-up exceeds 1e-3; a sample's IoU is equal where its argmax is, and
    the pixels that differ (all under that margin) are counted."""
    from lmsu_tpu_torch.common import build_loaders
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.experiments import kd_lift
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.visualize_predictions import compute_predictions
    args = kd_lift.make_parser().parse_args(["--output-root", root, "--num-val", "16",
                                             "--batch-size", "8"] + EXP_KERNELS)
    cfg = kd_lift._base_config(args)
    model = cfg.model
    weights = load_weights(os.path.join(root, "checkpoints", "kd_lift_student_s0", "best.pth"),
                           model)
    _, val = build_loaders(cfg, verbose=False)
    card = compute_predictions(Predictor(model, weights, device=dev), val, 16)
    cpu = compute_predictions(Predictor(model, weights, device="cpu"), val, 16)
    differ = card["pred"] != cpu["pred"]
    same_iou = [bool(a == b or (np.isnan(a) and np.isnan(b)))
                for a, b in zip(card["iou"], cpu["iou"])]
    res = {"samples": int(len(card["iou"])), "pixels_differ": int(differ.sum()),
           "max_cpu_margin_where_differ": float(cpu["margin"][differ].max()) if differ.any()
           else 0.0,
           "samples_iou_equal": int(sum(same_iou)),
           "iou_card": [float(v) for v in card["iou"]]}
    if not (np.array_equal(card["segmentation"], cpu["segmentation"])
            and res["max_cpu_margin_where_differ"] <= 1e-3
            and all(s or d.any() for s, d in zip(same_iou, differ))):
        raise AssertionError(f"visualize_predictions card != CPU: {res}")
    log(f"[experiments c] visualize_predictions compute, card vs CPU: {json.dumps(res)}")
    return res


# The KD step's kernels by their device function names (PROFILED's forwards).
PROFILED_KD = {"scatter_sorted_fwd": PROFILED["scatter_sorted_fwd"],
               "fusion_gate": PROFILED["fusion_gate"],
               "scatter_sorted_bwd": "scatter_sorted_bwd_kernel", "kd_feature_mse": "kd_mse_tc"}


def check_profiling(dev, root) -> dict:
    """(d) utils/profiling.py::profiler_trace around two B=128 f32 in-loop KD
    steps of weighted/128 (kernels on): the Chrome trace is written and K1's,
    K2's, K5's and K7's device functions appear in it. (e) StepTimer with
    the card around ten such steps, beside CUDA events recorded inside each
    interval: its p50 within 10% of the events' median; the same steps under
    a timer without the device are printed (the enqueue alone)."""
    from lmsu_tpu_torch.training import DistillationTrainer
    from lmsu_tpu_torch.utils.profiling import StepTimer, profiler_trace
    cfg = train_config(torch.float32)
    batch = train_batch(np.random.default_rng(11), TRAIN_B, dev)
    tr = DistillationTrainer(cfg, [batch], [batch], device=dev,
                             teacher_model_config=teacher_for(cfg))
    for _ in range(3):
        tr.train_step(batch)
    d = os.path.join(root, "trace")
    with profiler_trace(d):
        for _ in range(2):
            tr.train_step(batch)
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    seen = {k: any(fn in n for n in names) for k, fn in PROFILED_KD.items()}
    res = {"trace_mb": os.path.getsize(path) / 1e6, "kernels_in_trace": seen}
    if not all(seen.values()):
        raise AssertionError(f"profiler_trace: {res}")

    timer, events = StepTimer(warmup_steps=0, device=dev), []
    for _ in range(10):
        with timer:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            tr.train_step(batch)
            e1.record()
        events.append(e0.elapsed_time(e1))
    unsynced = StepTimer(warmup_steps=0)
    for _ in range(10):
        with unsynced:
            tr.train_step(batch)
    torch.cuda.synchronize()
    s = timer.summary(batch_size=TRAIN_B)
    res.update({"step_timer": s, "events_median_ms": float(np.median(events)),
                "unsynced_step_timer": unsynced.summary(batch_size=TRAIN_B)})
    res["p50_vs_events"] = s["p50_ms"] / res["events_median_ms"] - 1
    if abs(res["p50_vs_events"]) > 0.10:
        raise AssertionError(f"StepTimer with the device vs CUDA events: {res}")
    log(f"[experiments d, e] profiler_trace and StepTimer: {json.dumps(res)}")
    return res


def phase_experiments(dev) -> dict:
    """The experiments phase: (a) the eight KD experiments at the
    tiny regime, (b) analyze_weighted_gate, (c) visualize_predictions'
    compute part, card vs CPU, (d) profiler_trace and (e) StepTimer, every
    output under a temporary output root."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        res = {"runs": run_experiments(dev, root),
               "gate_analysis": check_gate_analysis(dev, root),
               "visualize": check_visualize_compute(dev, root),
               "profiling": check_profiling(dev, root)}
    res["seconds"] = time.perf_counter() - t0
    log(f"[experiments] phase {res['seconds']:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="kernels,serving,train,pandaset,parallel,experiments",
                    help="comma list of kernels,serving,train,pandaset,parallel,experiments "
                    "(build always runs)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
        # concat/256, the package's default model: 16 frames in f32 (K1, K3;
        # no K2), then one B=8 forward of each other fusion and the x4 head.
        sres["concat_f32"], _ = phase_serving(dev, torch.float32, n_frames=16, model="concat")
        for model in ("minimal", "gated_sum", "minimal_x4"):
            sres[f"forward_{model}"] = check_model_forward(dev, model)
            log(f"[serving {model}] B={B} forward: {json.dumps(sres[f'forward_{model}'])}")
        # Frozen weights, int8 and exported artifacts (the rest of serving).
        t0 = time.perf_counter()
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            sres[f"frozen_{dt}"] = check_frozen(dev, dtype, sd)
            log(f"[serving frozen {dt}] {json.dumps(sres[f'frozen_{dt}'])}")
        sres["int8_weighted"] = check_int8(dev, "weighted", sd)
        sres["int8_concat"] = check_int8(dev, "concat")
        for model in ("weighted", "concat"):
            log(f"[serving int8 {model}] {json.dumps(sres[f'int8_{model}'])}")
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            sres["export"] = check_export(dev, sd, d)
        sres["op_wrapper_cost"] = op_wrapper_cost(dev)
        log(f"[serving] operator wrapper cost: {json.dumps(sres['op_wrapper_cost'])}")
        log(f"[serving] frozen, int8 and artifacts: {time.perf_counter() - t0:.1f} s")
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
        # The concat/256 student (K7 at its post_fusion tap, Cs 256 / Ct 512)
        # and the minimal/128 one: the B=8 step check for concat, then the
        # in-loop B=128 step of each in f32 and bf16 (K1, K5, K7; no K2).
        tres["concat_check"] = check_kernel_vs_plain_step(dev, model="concat")
        log(f"[train] concat: kernel path == plain path: {json.dumps(tres['concat_check'])}")
        for model in ("concat", "minimal"):
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                run = tres[f"{model}_{dt}"] = phase_train(dev, dtype, variants=("in_loop",),
                                                          model=model)
                n = run["in_loop"]["launches"]
                if (any(n[k] <= 0 for k in ("scatter_sorted_fwd", "scatter_sorted_bwd",
                                            "kd_feature_mse")) or n["fusion_gate"]):
                    raise AssertionError(f"train {model} {dt}: launches {n}")
        # The best KD recipe (minimal/128, T=4, noisy-student augmentation,
        # the dataset-wide cache, the pallas scatter, K7): the CLI at full
        # width, its spill, its timed steps; then ensembles.
        import tempfile
        tres["augment_check"] = check_augment_on_card(dev)
        log(f"[train] augmentation on the card == on the CPU: "
            f"{json.dumps(tres['augment_check'])}")
        with tempfile.TemporaryDirectory() as d:
            # Both recipes whole (--scan-steps 13), on the host loop and on
            # the on-device epoch; the best recipe's epoch through each loop.
            for name, args, extra in (
                    ("recipe_cli", RECIPE_ARGS, ()),
                    ("recipe_cli_onchip", RECIPE_ARGS, ["--onchip-epoch"]),
                    ("crossarch_cli", CROSSARCH_ARGS, ()),
                    ("crossarch_cli_onchip", CROSSARCH_ARGS, ["--onchip-epoch"])):
                save = "student" if name == "recipe_cli" else name
                tres[name] = run_recipe_cli(dev, d, save, args, extra)
                log(f"[train] {name}: {json.dumps(tres[name])}")
            tres["recipe_loops"] = recipe_loops(dev, d)
            log(f"[train] recipe epoch through each loop: {json.dumps(tres['recipe_loops'])}")
            tres["recipe_spill"] = check_recipe_spill(dev, d)
            log(f"[train] recipe with the default cache limit (spilled): "
                f"{json.dumps(tres['recipe_spill'])}")
            tres["sigterm"] = check_sigterm_resume(dev, d)
            log(f"[train] SIGTERM, then --resume: {json.dumps(tres['sigterm'])}")
            tres["async_checkpoint"] = check_async_checkpoint(dev, d)
            log(f"[train] async checkpoint == sync: {json.dumps(tres['async_checkpoint'])}")
        tres["debug_nans"] = check_debug_nans(dev)
        log(f"[train] debug_nans: {json.dumps(tres['debug_nans'])}")
        # The cross-architecture recipe's student at full width: weighted/128
        # with PointPillars (528,324 parameters) and its spatial 2x teacher.
        tres["pillar_check"] = check_kernel_vs_plain_step(dev, model="weighted_pillars",
                                                          perturb=1e-7)
        log(f"[train] pillar student: kernel path == plain path: "
            f"{json.dumps(tres['pillar_check'])}")
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            run = tres[f"pillar_{dt}"] = phase_train(dev, dtype, variants=("in_loop",),
                                                     model="weighted_pillars")
            n = run["in_loop"]["launches"]
            if any(n[k] <= 0 for k in TRAIN_KERNELS):
                raise AssertionError(f"train pillar {dt}: launches {n}")
        tres["pillar_serving"] = check_model_forward(dev, "weighted_pillars")
        log(f"[serving weighted_pillars] B={B} forward: {json.dumps(tres['pillar_serving'])}")
        # Stage remat: the step against the step without it, then the timed
        # in-loop f32 step with and without remat, unfused and fused.
        tres["remat_check"] = check_remat_step(dev)
        log(f"[train] remat step == step without remat: {json.dumps(tres['remat_check'])}")
        for fused in (False, True):
            for remat in (False, True):
                key = f"remat_{'fused' if fused else 'unfused'}_{'on' if remat else 'off'}"
                tres[key] = phase_train(dev, torch.float32, warmup=2, steps=5,
                                        variants=("in_loop",), fused_train=fused, remat=remat)
            if fused and any(tres[key]["in_loop"]["launches"][k] <= 0
                             for k in IR_TRAIN_KERNELS):
                raise AssertionError(f"train {key}: launches {tres[key]['in_loop']['launches']}")
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            run = tres[f"recipe_{dt}"] = phase_train(
                dev, dtype, variants=("dataset_cache",), scatter="pallas", model="minimal",
                augment=recipe_augment(), kd={"temperature": 4.0})
            per_step = run["dataset_cache"]["launches_per_step"]
            # K6 in the student only (the teacher's outputs are cached), K7
            # once per tap.
            if per_step["voxelize_scatter_max"] != 1 or per_step["kd_feature_mse"] != 3:
                raise AssertionError(f"train recipe {dt}: launches per step {per_step}")
        tres["ensemble_check"] = check_ensemble(dev)
        log(f"[train] ensemble: {json.dumps(tres['ensemble_check'])}")
        run = tres["ensemble_f32"] = phase_train(dev, torch.float32, variants=("in_loop",),
                                                 scatter="pallas", model="minimal",
                                                 kd={"ensemble_size": 2})
        if run["in_loop"]["launches_per_step"]["voxelize_scatter_max"] != 3:
            raise AssertionError(f"train ensemble: launches per step "
                                 f"{run['in_loop']['launches_per_step']}")
        tres["ablation_cli"] = run_ablation_cli(dev)
        log(f"[train] train_fusion_ablation CLI: {json.dumps(tres['ablation_cli'])}")
        tres["synthetic_cli"] = run_synthetic_cli(dev)
        log(f"[train] train_synthetic + evaluate CLIs: {json.dumps(tres['synthetic_cli'])}")
        log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    pres = phase_parallel(dev) if "parallel" in phases else {}
    if "pandaset" in phases:
        tres["pandaset_cli"] = run_pandaset_cli(dev)
        log(f"[pandaset] frames, packs, train_pandaset + evaluate CLIs: "
            f"{json.dumps(tres['pandaset_cli'])}")
    eres = phase_experiments(dev) if "experiments" in phases else {}

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
        # This slice's own paths: the concat/256 serving run and the
        # concat/256 and minimal/128 f32 KD runs.
        if path == "serving" and "concat_f32" in sres:
            entry["concat256_serving_launches"] = sres["concat_f32"]["launches"][name]
        # The artifacts' runs (one B=8 call each): K1-K3 from the serving
        # artifact, K4 and K6 from theirs; K1-K3 also from the frozen forward.
        if "export" in sres and path.startswith("serving"):
            run = {"serving": "point_valid", "serving_flat": "flat_k4",
                   "serving_pallas": "pallas_k6"}[path]
            entry["export_launches"] = sres["export"][run]["launches"].get(name, 0)
            if path == "serving":
                entry["frozen_launches"] = sres["frozen_f32"]["launches"].get(name, 0)
                entry["op_wrapper_cost_us"] = sres["op_wrapper_cost"][name]["op_cost_us"]
        if name in ("voxelize_scatter_max", "kd_feature_mse") and "recipe_cli" in tres:
            for run in ("recipe_cli", "recipe_cli_onchip", "crossarch_cli",
                        "crossarch_cli_onchip"):
                entry[f"{run}_launches"] = tres[run]["launches"][name]
            entry["recipe_train_launches"] = \
                tres["recipe_f32"]["dataset_cache"]["launches"][name]
        if "pandaset_cli" in tres:
            entry["pandaset_train_launches"] = tres["pandaset_cli"]["launches"][name]
        if eres:
            # The experiments phase: each experiment's whole run at the tiny
            # regime, and analyze_weighted_gate's (b).
            entry["experiments_launches"] = {
                **{d: r["launches"].get(name, 0) for d, r in eres["runs"].items()},
                "analyze_weighted_gate": eres["gate_analysis"]["launches"].get(name, 0)}
        if pres:
            # The parallel phase: the world-1 NCCL step's 3 steps, rank 0's 3
            # steps of each two-rank gloo run, the devices=[card] engine's 16
            # frames.
            entry["parallel_launches"] = {
                "world1_nccl_f32_fused": pres["world1_nccl"]["launches"].get(name, 0),
                **{f"gloo_rank0_{run}": r["launches_rank0"].get(name, 0)
                   for run, r in pres["gloo_two_ranks"]["runs"].items()},
                # The model axis: rank 0's steps of each (e) and (f) run.
                **{f"model_axis_{cell}_rank0_{run}": r["launches_rank0"].get(name, 0)
                   for cell in ("e", "f")
                   for run, r in pres["model_axis"][cell]["runs"].items()},
                "serving_devices": pres["serving"]["launches"].get(name, 0)}
        if "pillar_f32" in tres:
            if path in ("serving", "train"):
                entry["pillar_train_launches"] = tres["pillar_f32"]["in_loop"]["launches"][name]
            if path == "serving":
                entry["pillar_serving_launches"] = tres["pillar_serving"]["launches"].get(name, 0)
            if path == "fused_train":
                entry["remat_fused_train_launches"] = \
                    tres["remat_fused_on"]["in_loop"]["launches"][name]
        if path in ("serving", "train"):
            for model in ("concat", "minimal"):
                if f"{model}_f32" in tres:
                    entry[f"{model}_train_launches"] = \
                        tres[f"{model}_f32"]["in_loop"]["launches"][name]
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
    log(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": lines}))
    if sres:
        print(json.dumps({"serving": {k: v["stats"] for k, v in sres.items() if "stats" in v},
                          "card": smi}))
    if "export" in sres:
        fwd = {k: {f"{m}_device_ms": v["device_ms"] for m, v in sres[k]["forward"].items()}
               for k in ("frozen_f32", "frozen_bf16")}
        for model in ("weighted", "concat"):
            run = sres[f"int8_{model}"]
            fwd[f"int8_{model}"] = {k: v["device_ms"] for k, v in run["forward_b8"].items()}
            fwd[f"int8_{model}"]["layers_mkn_int8_ms_f32_ms"] = [
                (x["M"], x["K"], x["N"], x["int8_ms"], x["float_1x1_ms"]) for x in run["layers"]]
            fwd[f"int8_{model}"]["err_of_scale"] = run["err_int8_vs_float_of_scale"]
            fwd[f"int8_{model}"]["agreement"] = run["argmax_agreement_decisive"]
            fwd[f"int8_{model}"]["frozen_vs_int8"] = run["err_frozen_int8_vs_int8"]
        print(json.dumps({"serving_rest": {
            **fwd, "artifacts": {k: {**{f: v[f] for f in ("size_mb", "export_s", "load_s",
                                                         "err_vs_in_process_of_scale",
                                                         "err_vs_unfrozen_of_scale", "launches")},
                                     "device_ms": v["forward"]["device_ms"],
                                     "in_process_device_ms": v["in_process_forward"]["device_ms"],
                                     "wall_ms": v["forward"]["wall_ms_median"],
                                     "in_process_wall_ms":
                                         v["in_process_forward"]["wall_ms_median"]}
                                 for k, v in sres["export"].items() if k != "served"},
            "served_startup_s": sres["export"]["served"]["startup_s"],
            "served_artifact": sres["export"]["served"]["stats"],
            "op_wrapper_cost_us": {k: v["op_cost_us"]
                                   for k, v in sres["op_wrapper_cost"].items()}},
            "card": smi}))
    if "pandaset_cli" in tres:
        pc = tres["pandaset_cli"]
        print(json.dumps({"pandaset": {
            **{k: pc.get(k) for k in ("route", "points_a_sweep", "decode_ms_a_frame",
                                      "decode_ms_a_frame_numpy", "pack_seconds",
                                      "epoch_seconds", "best_val_miou", "seconds")},
            "k1_k5_launches": [pc["launches"]["scatter_sorted_fwd"],
                               pc["launches"]["scatter_sorted_bwd"]],
            "padded_scatter": pc["padded_scatter"], "raw_tree": pc["raw_tree"]},
            "card": smi}))
    if tres.keys() - {"pandaset_cli"}:
        summary = {dt: {v: {k: tres[dt][v][k] for k in ("step_ms", "frames_per_s")}
                        for v in ("in_loop", "cached")} for dt in ("f32", "bf16")}
        for dt in ("f32", "bf16"):
            for run, key in (("fused", "fused_train"), ("pallas", "pallas_scatter"),
                             ("concat", "concat256"), ("minimal", "minimal128")):
                summary[f"{key}_{dt}"] = {"in_loop": {
                    k: tres[f"{run}_{dt}"]["in_loop"][k] for k in ("step_ms", "frames_per_s")}}
        for dt in ("f32", "bf16"):
            run = tres[f"recipe_{dt}"]["dataset_cache"]
            summary[f"recipe_{dt}"] = {"dataset_cache": {
                **{k: run[k] for k in ("step_ms", "frames_per_s")},
                "idle_share": run["profile"]["idle_share"],
                "augment_ms": run["profile"]["spans_device_ms"]["augment"],
                "gather_ms": run["profile"]["spans_device_ms"]["teacher_cache_gather"]}}
        summary["ensemble2_f32"] = {"in_loop": {
            k: tres["ensemble_f32"]["in_loop"][k] for k in ("step_ms", "frames_per_s")}}
        summary["recipe_spill"] = {k: tres["recipe_spill"][k]
                                   for k in ("gather_ms_per_step", "spill_ms_per_step")}
        summary["recipe_loops"] = {
            k: {f: v.get(f) for f in ("seconds", "idle_share", "input_stall")}
            for k, v in tres["recipe_loops"]["epochs"].items()}
        summary["recipe_cli_epochs"] = {
            k: tres[k]["epochs_teacher_then_student"]
            for k in ("recipe_cli", "recipe_cli_onchip", "crossarch_cli", "crossarch_cli_onchip")}
        for dt in ("f32", "bf16"):
            run = tres[f"pillar_{dt}"]["in_loop"]
            summary[f"pillar_{dt}"] = {"in_loop": {
                **{k: run[k] for k in ("step_ms", "frames_per_s")},
                "idle_share": run["profile"]["idle_share"],
                "peak_mem_gb": tres[f"pillar_{dt}"]["peak_mem_gb"]}}
        summary["remat_f32"] = {
            k[len("remat_"):]: {"step_ms": tres[k]["in_loop"]["step_ms"],
                                "peak_mem_gb": tres[k]["peak_mem_gb"]}
            for k in tres if k.startswith("remat_") and k != "remat_check"}
        print(json.dumps({"train": summary, "batch": TRAIN_B, "card": smi}))
    if pres:
        print(json.dumps({"parallel": {
            "world1_nccl": {k: pres["world1_nccl"][k] for k in (
                "first_step_forward_bit_equal", "plain_first_step_forward_repeats",
                "three_steps_bit_equal", "plain_three_steps_repeat", "step_ms_mesh",
                "step_ms_no_mesh")},
            "gloo_two_ranks": {run: {k: v for k, v in r.items() if k not in (
                "held_step0", "launches_rank0")} for run, r in
                pres["gloo_two_ranks"]["runs"].items()},
            "model_axis": {
                "e_batch_per_rank": pres["model_axis"]["e"]["batch_per_rank"],
                "teacher": pres["model_axis"]["e"]["teacher"],
                "teacher_bytes": pres["model_axis"]["e"]["teacher_bytes"],
                "peak_forward_bytes": pres["model_axis"]["e"]["peak_forward_bytes"],
                **{f"{cell}_{run}": {**{k: r[k] for k in (
                    "step_ms", "step_ms_median", "step_ms_one_process_median",
                    "collectives_per_step_by_axis", "sha256_ranks", "peak_gb_rank0")},
                    "held": {k: v for k, v in r["held_step0"].items() if k != "largest_diffs"}}
                   for cell in ("e", "f") for run, r in pres["model_axis"][cell]["runs"].items()},
                "seconds": pres["model_axis"]["seconds"]},
            "run_multiprocess": pres["run_multiprocess"], "seconds": pres["seconds"]},
            "card": smi}))
    if eres:
        print(json.dumps({"experiments": {
            "runs": {d: {"seconds": r["seconds"], "mious": r["mious"]}
                        for d, r in eres["runs"].items()},
            "gate_variants": {k: eres["gate_analysis"][k] for k in (
                "trained", "uniform", "camera_only", "lidar_only")},
            "visualize": {k: v for k, v in eres["visualize"].items() if k != "iou_card"},
            "profiling": eres["profiling"], "seconds": eres["seconds"]}, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
