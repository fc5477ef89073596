"""The data-parallel mesh: one process per device, over torch.distributed.

Counterpart of lmsu_tpu/parallel/mesh.py. In JAX a sharded batch is one
program over the global batch, and GSPMD makes BatchNorm statistics, loss
normalisers, the confusion matrix and the gradient exact over it. The port
runs PyTorch's idiom instead: one process (rank) per device, each fed its
stripe of every global batch, and the collectives placed by hand:

  * BatchNorm (models/layers.py) and the fused blocks (ops/ir_fused.py)
    all-reduce their sums and counts, so their statistics are the global
    batch's; `all_reduce_sum` carries the cotangents back the same way;
  * the loss normalisers (ops/losses.py, ops/kd_loss.py) are global totals,
    reduced once a step, so each rank's loss is its share of the global
    loss and the gradients SUM over ranks: one flat all-reduce before the
    optimizer (training/trainer.py);
  * the epoch's loss sums and confusion matrix are reduced once an epoch.

After any number of steps, N ranks over a global batch B give what one
process gives over B, up to the order of f32 sums.

`make_mesh` reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
MASTER_PORT, or takes an explicit `init_method` (tests use file:// in a
temporary directory). NCCL on CUDA, gloo on the CPU; gloo on CUDA only when
the caller asks for it (two ranks sharing one card, which NCCL refuses;
gloo takes the CUDA tensors as they are, checked on an H100 with torch
2.11). The group has a timeout, so a collective that hangs raises. Without
a process group (no torchrun environment, no init_method) the mesh is one
device and every collective here is the identity.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lmsu_tpu_torch.config import MeshConfig

DEFAULT_TIMEOUT_S = 90.0

_ACTIVE: Optional["Mesh"] = None


@dataclass
class Mesh:
    """A 1-D data mesh: this process's rank, the world size, its device and
    the process group (None at world size 1 without a group)."""

    config: MeshConfig
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]
    group: Optional[object] = None
    # Collective calls, bytes and host seconds since the last reset.
    counts: Dict[str, float] = field(default_factory=lambda: {"calls": 0, "bytes": 0,
                                                               "seconds": 0.0})

    def reset_counts(self) -> None:
        self.counts.update(calls=0, bytes=0, seconds=0.0)


def check_model_parallel(config: MeshConfig) -> None:
    """model_parallel > 1 (the 2-D mesh) is not ported: refused by name."""
    if config.model_parallel > 1:
        raise NotImplementedError("not ported yet: MeshConfig.model_parallel > 1 "
                                  "(tp/sp teacher on a 2-D mesh)")


def check_mesh_config(config: MeshConfig, world_size: int) -> None:
    """model_parallel > 1 is not ported; num_devices, when set, must be the
    world size."""
    check_model_parallel(config)
    if config.num_devices is not None and config.num_devices != world_size:
        raise ValueError(f"MeshConfig.num_devices={config.num_devices} but the process group "
                         f"has {world_size} ranks (one device a rank)")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def launched_distributed() -> bool:
    """Whether this process was started as a rank of a group (torchrun's
    WORLD_SIZE is set)."""
    return _env_int("WORLD_SIZE") is not None


def make_mesh(config: Optional[MeshConfig] = None, *, backend: Optional[str] = None,
              device=None, init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The data mesh of this process, made active (BatchNorm, the fused
    blocks and the loaders read it).

    Rank and world size come from the arguments, else from torchrun's RANK
    and WORLD_SIZE. A process group is made when an init_method is given or
    WORLD_SIZE is set (env://, MASTER_ADDR / MASTER_PORT); else the mesh is
    this one device with no group. The device is cuda:LOCAL_RANK unless
    `device` names another (the CPU for tests); a CUDA device without CUDA
    raises, and there is no fallback. `backend` defaults to nccl on CUDA and
    gloo on the CPU."""
    global _ACTIVE
    config = config or MeshConfig()
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    env_world = _env_int("WORLD_SIZE")
    world = world_size if world_size is not None else (env_world or 1)
    check_mesh_config(config, world)
    local = _env_int("LOCAL_RANK")
    dev = torch.device(device if device is not None
                       else f"cuda:{local if local is not None else 0}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {dev} asked for but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world size {world}")
    want_group = init_method is not None or env_world is not None
    if not want_group:
        if backend is not None:
            raise ValueError("a backend needs a process group: pass init_method or run "
                             "under torchrun")
        mesh = Mesh(config, 0, 1, dev, None)
        _ACTIVE = mesh
        return mesh
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("make_mesh: backend nccl asked for but this torch has no NCCL")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend nccl needs a CUDA device")
    if not dist.is_initialized():
        kw = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout_s))
        if init_method is not None:
            kw["init_method"] = init_method
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(**kw)
    mesh = Mesh(config, dist.get_rank(), dist.get_world_size(), dev, backend,
                group=dist.group.WORLD)
    _ACTIVE = mesh
    return mesh


def active() -> Optional[Mesh]:
    """The mesh made last by make_mesh (None before any, or after destroy)."""
    return _ACTIVE


@contextlib.contextmanager
def using(mesh: Optional[Mesh]):
    """Make `mesh` the active mesh inside the block (None: none, so every
    layer reduces over this process alone, as a one-process reference inside
    a rank does), and restore the one before after it."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = before


def data_mesh() -> Optional[Mesh]:
    """The active mesh when it spans more than one rank, else None: the
    layers that reduce over the data axis do nothing else at world size 1."""
    m = _ACTIVE
    return m if m is not None and m.world_size > 1 else None


def world_size(mesh: Optional[Mesh] = None) -> int:
    m = mesh if mesh is not None else _ACTIVE
    return m.world_size if m is not None else 1


def destroy(mesh: Optional[Mesh] = None) -> None:
    """Leave the process group (if this mesh made one) and deactivate."""
    global _ACTIVE
    m = mesh if mesh is not None else _ACTIVE
    if m is not None and m.group is not None and dist.is_initialized():
        dist.destroy_process_group()
    if _ACTIVE is m:
        _ACTIVE = None


# -- the index math (JAX: process_data_stripes, local_shard_slices) ------------


def process_data_stripes(mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(num_stripes, stripe_index) of this process: on the 1-D mesh
    (world_size, rank). Feed it to make_loader(num_shards=..., shard_index=...)."""
    m = mesh if mesh is not None else _ACTIVE
    return (m.world_size, m.rank) if m is not None else (1, 0)


def local_shard_slices(global_shape: Sequence[int], num_shards: int,
                       shards: Optional[Sequence[int]] = None) -> List[Tuple[int, slice]]:
    """[(shard, dim-0 slice of the global batch)] for `shards` (all by
    default), sorted by row start: shard s holds rows [s*B/n, (s+1)*B/n)."""
    B = int(global_shape[0])
    if B % num_shards:
        raise ValueError(f"global batch {B} not divisible by {num_shards} shards")
    L = B // num_shards
    shards = range(num_shards) if shards is None else shards
    return sorted(((s, slice(s * L, (s + 1) * L)) for s in shards), key=lambda t: t[1].start)


# -- collectives ---------------------------------------------------------------


def _run(mesh: Mesh, fn, tensors: Sequence[torch.Tensor]) -> None:
    """fn(tensors), a collective over them in place, timed and counted."""
    t0 = time.perf_counter()
    fn(list(tensors))
    mesh.counts["calls"] += 1
    mesh.counts["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    mesh.counts["seconds"] += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, op: str = "sum", mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-place sum (or max) all-reduce of a contiguous tensor over the data
    axis; the identity at world size 1. Returns t."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run(m, lambda ts: dist.all_reduce(ts[0], op=rop, group=m.group), [t])
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the cotangent is summed over ranks too (each rank's
    output feeds its own share of the global loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), mesh=ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Differentiable sum over the data axis (the identity, x itself, at
    world size 1)."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return x
    return _AllReduceSum.apply(x, m)


def all_gather(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's `t` (same shape on each) concatenated on dim 0, in rank
    order; t itself at world size 1."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return t
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(m.world_size)]

    def gather(ts):
        dist.all_gather(ts[1:], ts[0], group=m.group)
    _run(m, gather, [t] + outs)
    return torch.cat(outs)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               mesh: Optional[Mesh] = None) -> None:
    """Overwrite `tensors` in place with rank `src`'s (the counterpart of
    replicate: parameters and buffers at start-up)."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return
    for t in tensors:
        if t.numel() == 0:
            continue
        with torch.no_grad():
            buf = t.detach() if t.is_contiguous() else t.detach().contiguous()
            _run(m, lambda ts: dist.broadcast(ts[0], src, group=m.group), [buf])
            if buf is not t:
                t.detach().copy_(buf)


def broadcast_module_(module: torch.nn.Module, src: int = 0,
                      mesh: Optional[Mesh] = None) -> None:
    """Rank `src`'s parameters and buffers on every rank."""
    broadcast_(list(module.parameters()) + list(module.buffers()), src, mesh)


# -- launching ranks -------------------------------------------------------------


def _tail(f, n: Optional[int] = 4000) -> str:
    """The last n characters written to f (all of them: n None)."""
    f.seek(0)
    text = f.read()
    return text if n is None else text[-n:]


def run_ranks(commands: Sequence[Sequence[str]], timeout: float, *, env=None, cwd=None,
              while_running=None):
    """Run one process a command (the ranks of a group, and any process
    that must end with them) and wait for all of them. `while_running()`,
    when given, runs in this process meanwhile. A process that exits
    non-zero, or any still running `timeout` seconds after the start, fails
    the run at once: RuntimeError with the tail of its output; no process is
    left running. Output goes to temporary files, so a rank that writes much
    never blocks on a full pipe. Returns (each process's stdout and stderr,
    in order; while_running's result)."""
    deadline = time.monotonic() + timeout
    logs = [tempfile.TemporaryFile(mode="w+") for _ in commands]
    procs = []
    try:
        for cmd, f in zip(commands, logs):
            procs.append(subprocess.Popen(list(cmd), stdout=f, stderr=subprocess.STDOUT,
                                          env=env, cwd=cwd, text=True))
        extra = while_running() if while_running is not None else None
        while True:
            codes = [p.poll() for p in procs]
            bad = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            if bad is not None:
                raise RuntimeError(f"process {bad} ({' '.join(commands[bad][1:4])} ...) exited "
                                   f"{codes[bad]}:\n{_tail(logs[bad])}")
            if all(c == 0 for c in codes):
                return [_tail(f, None) for f in logs], extra
            if time.monotonic() > deadline:
                late = [i for i, c in enumerate(codes) if c is None]
                raise RuntimeError(f"processes {late} still running after {timeout:.0f} s:\n"
                                   f"{_tail(logs[late[0]])}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
