"""Run a real multi-process data-parallel KD epoch and check it against one
process.

Counterpart of scripts/run_multiprocess.py for the PyTorch port:

  * launcher mode (default): spawns N worker processes of this module, one
    rank each, joined into one process group (file:// rendezvous in a
    temporary directory), and beside them a single-process reference worker
    over the same global batch, run twice: from the seeded weights and from
    those weights moved by 1e-6 of themselves (parallel/mesh.py::run_ranks:
    a worker that fails or outlives --timeout fails the run); then asserts
      - every rank reports the same results (one global program, the
        parameters equal bit for bit),
      - the ranks' results match the single-process reference within a
        fixed margin (1e-6 of the loss, 1e-6 of mIoU) plus 10x the
        reference's own spread under that perturbation: the ranks sum in
        another order, and at this size the second AdamW step turns f32
        rounding into changes of ~1e-4 of the loss (tests/test_torch_kd_step.py),
      - the ranks decoded disjoint stripes that cover every sample (with
        --model-parallel M, the M ranks of one model group the same one);
  * worker mode (--process-id): one KD training epoch + validation on tiny
    shapes through the production path: the Batcher's stripe decoding,
    synced BatchNorm, global loss normalisers, the gradient all-reduce, the
    teacher-cache fill forced onto the host-memory path
    (cache_hbm_limit_bytes=0) and completed by all-gathers, precached KD
    steps; --teacher-partition fsdp shards the teacher's storage over the
    data axis. --model-parallel M > 1 makes the ranks a 2-D (data, model)
    mesh (one process a device, so the model axis always spans processes):
    under tp the worker asserts that some teacher leaf is split, under sp
    that the image rows are.

Each rank runs on --device: CUDA (the default; no CUDA device raises),
rank r on cuda:(r mod device count), NCCL when every rank has a card of its
own, else gloo (NCCL refuses two ranks on one card), unless --backend says;
or the CPU (gloo). With CUDA the launcher builds every kernel before it
starts the workers. The workers run at once, so the epoch seconds they
report share the host and the card.

Usage:
  python -m lmsu_tpu_torch.run_multiprocess --device cpu     # 2 ranks, CPU
  python -m lmsu_tpu_torch.run_multiprocess --device cpu --num-processes 4 \
      --model-parallel 2 --teacher-partition sp             # a 2 x 2 mesh
  python -m lmsu_tpu_torch.run_multiprocess --num-processes 2 \\
      --teacher-partition fsdp --scatter-impl sorted_pallas  # on the card(s)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

from lmsu_tpu_torch.parallel.mesh import run_ranks

BATCH = 16  # the global batch: 2 steps an epoch over N_TRAIN samples
N_TRAIN = 2 * BATCH


def _config(args, save_dir: str):
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       KDConfig, LidarEncoderConfig, MeshConfig, ModelConfig,
                                       TrainConfig)
    return ExperimentConfig(
        model=ModelConfig(
            num_classes=2, fusion_type="concat", fusion_out_channels=32,
            camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),
            lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8),
                                     scatter_impl=args.scatter_impl)),
        data=DataConfig(dataset="synthetic", synthetic_num_train=N_TRAIN,
                        synthetic_num_val=BATCH, image_size=(32, 32), grid_size=(8, 8),
                        max_points=64, batch_size=BATCH),
        train=TrainConfig(
            num_epochs=1, class_weights=(0.4, 3.5), save_dir=save_dir,
            kd=KDConfig(enabled=True, feature_taps=("camera_feat", "post_fusion"),
                        cache_teacher=True,
                        # The single-process reference runs the whole teacher.
                        teacher_partition=(args.teacher_partition if args.num_processes > 1
                                           else "tp"),
                        # The host-memory path: what every data-parallel run takes.
                        cache_hbm_limit_bytes=0)),
        mesh=MeshConfig(model_parallel=args.model_parallel if args.num_processes > 1 else 1))


def worker(args) -> None:
    import torch
    torch.set_num_threads(1)
    from lmsu_tpu_torch.data import SyntheticMultiModalDataset, make_loader
    from lmsu_tpu_torch.data.rasterize import make_point_sorter
    from lmsu_tpu_torch.inference import pin_f32_precision
    from lmsu_tpu_torch.parallel import mesh as pmesh
    from lmsu_tpu_torch.training import DistillationTrainer
    pin_f32_precision()

    n = args.num_processes
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    else:
        device = torch.device(args.device)
    cfg = _config(args, os.path.join(args.tmp, f"run_p{args.process_id}_of_{n}"))
    mesh = None
    if n > 1:
        mesh = pmesh.make_mesh(cfg.mesh, device=device, backend=args.backend,
                               init_method=args.init_method, rank=args.process_id,
                               world_size=n, timeout_s=args.timeout)
    num_stripes, stripe_index = pmesh.process_data_stripes(mesh)
    ds = SyntheticMultiModalDataset(num_samples=N_TRAIN, image_size=cfg.data.image_size,
                                    grid_size=cfg.data.grid_size,
                                    max_points=cfg.data.max_points)
    val_ds = SyntheticMultiModalDataset(num_samples=BATCH, image_size=cfg.data.image_size,
                                        grid_size=cfg.data.grid_size,
                                        max_points=cfg.data.max_points, seed=10_000)
    transform = None
    if args.scatter_impl == "sorted_pallas":
        transform = make_point_sorter(cfg.model.lidar.grid_size,
                                      cfg.model.lidar.point_cloud_range)
    # make_loader takes its stripe from the active mesh.
    train_loader = make_loader(ds, BATCH, shuffle=False, sample_transform=transform)
    val_loader = make_loader(val_ds, BATCH, shuffle=False, sample_transform=transform)
    decoded = sorted(int(i) for b in train_loader.batcher for i in b["sample_index"])

    trainer = DistillationTrainer(cfg, train_loader, val_loader, device=device, mesh=mesh)
    if args.perturb:
        import numpy as np
        noise = np.random.default_rng(3)
        with torch.no_grad():
            for p in trainer.params.values():
                p.mul_(1 + args.perturb * torch.from_numpy(
                    noise.standard_normal(tuple(p.shape)).astype(np.float32)).to(p.device))
    t0 = time.perf_counter()
    train_loss, train_metrics = trainer.train_epoch()
    if trainer.teacher_cache_host is None:
        raise AssertionError("expected the host-memory teacher-cache path")
    val_loss, val_metrics = trainer.validate()
    seconds = time.perf_counter() - t0
    shards = trainer.teacher_shards
    M = cfg.mesh.model_parallel
    if (args.teacher_partition == "fsdp" and n // M > 1) or (
            args.teacher_partition == "tp" and M > 1):
        # The teacher's leaves must really be split (over the data axis for
        # fsdp, the model axis for tp), not silently replicated.
        if not (shards is not None and shards.bytes_per_rank < shards.bytes_full):
            raise AssertionError(f"{args.teacher_partition} teacher: no leaf is actually "
                                 "split")
    if args.teacher_partition == "sp" and n > 1 and not (trainer.teacher_layout == "sp"
                                               and shards.halos > 0):
        raise AssertionError("sp teacher: the image rows are not split")
    teacher_bytes = sum(t.numel() * t.element_size()
                        for t in list(trainer.teacher.parameters())
                        + list(trainer.teacher.buffers()))
    result = {
        "process_id": args.process_id, "num_processes": n, "device": str(device),
        "backend": mesh.backend if mesh is not None else None,
        "teacher_partition": args.teacher_partition, "scatter_impl": args.scatter_impl,
        "teacher_layout": trainer.teacher_layout,
        "model_parallel": M, "num_stripes": num_stripes, "stripe_index": stripe_index,
        "decoded_indices": decoded,
        "train_loss": float(train_loss), "train_miou": float(train_metrics["miou"]),
        "val_loss": float(val_loss), "val_miou": float(val_metrics["miou"]),
        "loss_parts": trainer.last_loss_parts,
        "teacher_bytes_between_forwards": getattr(shards, "bytes_per_rank", teacher_bytes),
        "teacher_bytes_full": getattr(shards, "bytes_full", teacher_bytes),
        "collectives": mesh.axis_counts() if mesh is not None else None,
        "seconds": seconds,
        "params_sha256": hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in trainer.params.values())).hexdigest(),
    }
    with open(args.output, "w") as f:
        json.dump(result, f)
    print(f"worker {args.process_id}/{n}: train loss {train_loss:.6f} "
          f"val mIoU {val_metrics['miou']:.4f}", flush=True)
    pmesh.destroy(mesh)


def _command(args, pid: int, nproc: int, tmp: str, init: str, perturb: float = 0.0):
    """(the worker's command line, its result file)."""
    out = os.path.join(tmp, f"result_p{pid}_of_{nproc}{'_perturbed' if perturb else ''}.json")
    cmd = [sys.executable, "-m", "lmsu_tpu_torch.run_multiprocess", "--process-id", str(pid),
           "--num-processes", str(nproc), "--output", out, "--device", args.device,
           "--teacher-partition", args.teacher_partition, "--scatter-impl", args.scatter_impl,
           "--model-parallel", str(args.model_parallel),
           "--init-method", init, "--tmp", tmp, "--timeout", str(args.timeout),
           "--perturb", str(perturb)]
    if args.backend:
        cmd += ["--backend", args.backend]
    return cmd, out


def launch(args) -> dict:
    n, M = args.num_processes, args.model_parallel
    if M < 1 or n % M:
        raise SystemExit(f"--model-parallel {M} must divide --num-processes {n}")
    if BATCH % (n // M):
        raise SystemExit(f"the data axis (--num-processes / --model-parallel) must divide "
                         f"the global batch {BATCH}")
    if args.teacher_partition == "sp" and M == 1:
        raise SystemExit("--teacher-partition sp needs --model-parallel > 1")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        if args.backend is None:
            args.backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
        from lmsu_tpu_torch.ops._cuda import build_all
        build_all()  # before the ranks start: they then load the same build
    print(f"launching {n} ranks on {args.device} (backend {args.backend or 'gloo'}), and "
          "beside them the single-process reference over the same global batch, from the "
          "weights and from the weights moved by 1e-6 of themselves ...", flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="lmsu_torch_mp_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        runs = ([_command(args, i, n, tmp, init) for i in range(n)]
                + [_command(args, 0, 1, tmp, "", perturb) for perturb in (0.0, 1e-6)])
        run_ranks([cmd for cmd, _ in runs], args.timeout, env=env)
        *dist, ref, pert = [json.load(open(out)) for _, out in runs]

    # 1. the ranks agree (one global program; parameters alike).
    for r in dist[1:]:
        for k in ("train_loss", "val_loss", "train_miou", "val_miou", "params_sha256"):
            if r[k] != dist[0][k]:
                raise AssertionError(f"ranks disagree on {k}: {r[k]} != {dist[0][k]}")
    # 2. disjoint stripes covering the dataset exactly once; the ranks of
    #    one model group (the same stripe index) decode the same one.
    stripes = {}
    for r in dist:
        if stripes.setdefault(r["stripe_index"], r["decoded_indices"]) != r["decoded_indices"]:
            raise AssertionError("the ranks of one model group decoded different stripes")
    all_idx = sorted(i for v in stripes.values() for i in v)
    if all_idx != list(range(N_TRAIN)) or len(stripes) != n // M:
        raise AssertionError("stripes overlap or miss samples")
    if any(len(v) != N_TRAIN // (n // M) for v in stripes.values()):
        raise AssertionError("stripes of unequal size")
    # 3. distributed == single process over the same global batch, up to the
    #    order of f32 sums: a fixed margin plus 10x the reference's spread.
    held = {}
    for k in ("train_loss", "val_loss", "train_miou", "val_miou"):
        err, spread = abs(dist[0][k] - ref[k]), abs(pert[k] - ref[k])
        fixed = 1e-6 * abs(ref[k]) if k.endswith("loss") else 1e-6
        tol = fixed + 10 * spread
        held[k] = {"err": err, "spread": spread, "tol": tol}
        if err > tol:
            raise AssertionError(f"{k}: {dist[0][k]} distributed vs {ref[k]} single: "
                                 f"{err:g} > {tol:g} (reference spread {spread:g})")

    summary = {
        "num_processes": n, "devices_total": n, "device": args.device,
        "backend": dist[0]["backend"],
        "teacher_partition": args.teacher_partition, "scatter_impl": args.scatter_impl,
        "model_parallel": M, "num_stripes": dist[0]["num_stripes"],
        # One process a device: a model axis of more than one rank spans processes.
        "model_axis_spans_processes": M > 1, "teacher_layout": dist[0]["teacher_layout"],
        "train_loss_distributed": dist[0]["train_loss"], "train_loss_single": ref["train_loss"],
        "val_miou_distributed": dist[0]["val_miou"], "val_miou_single": ref["val_miou"],
        "held_to_reference": held,
        "stripes_disjoint_and_complete": True, "host_spill_teacher_cache": True,
        "teacher_bytes_per_rank": dist[0]["teacher_bytes_between_forwards"],
        "teacher_bytes_full": dist[0]["teacher_bytes_full"],
        "collectives_rank0": dist[0]["collectives"],
        "epoch_seconds_distributed": dist[0]["seconds"], "epoch_seconds_single": ref["seconds"],
    }
    print("OK — multi-process result matches single-process:")
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="where each rank runs (cuda: rank r on cuda:(r mod device count); "
                   "cpu: gloo, as the tests run it)")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="default: gloo on the CPU; on CUDA nccl when every rank has a card "
                   "of its own, else gloo")
    p.add_argument("--teacher-partition", default="tp", choices=["tp", "sp", "fsdp"],
                   help="KDConfig.teacher_partition ('tp' on the 1-D mesh = a replicated "
                   "teacher, on the 2-D mesh split by channel over the model axis; 'sp' "
                   "splits its image rows over the model axis and needs --model-parallel "
                   "> 1; 'fsdp' shards its storage over the data axis)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="MeshConfig.model_parallel: the ranks form a 2-D ('data','model') "
                   "mesh, data-major; one process a device, so the model axis spans "
                   "processes: the teacher's gathers and halo exchanges ride the "
                   "inter-process collectives, and the processes of one model group "
                   "decode identical batch stripes")
    p.add_argument("--scatter-impl", default="xla",
                   choices=["xla", "xla_fastbwd", "sorted", "pallas", "sorted_pallas"])
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a rank may take, and the process group's timeout")
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--output", default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    p.add_argument("--tmp", default=None, help=argparse.SUPPRESS)
    p.add_argument("--perturb", type=float, default=0.0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.process_id is not None:
        worker(args)
        return None
    return launch(args)


if __name__ == "__main__":
    main()
