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

The 2-D mesh (MeshConfig.model_parallel = M > 1) is the JAX package's
data-major `reshape(n / M, M)`: rank r sits at data coordinate d = r // M
and model coordinate m = r % M, so the M ranks of one model group (same
d) are neighbours. Every rank builds every data group (same m) and every
model group (same d), in one fixed order, with the mesh's timeout. The
student is data-parallel over the DATA axis and replicated along the model
axis: `data_mesh()` (BatchNorm, the fused blocks' sums, the loss
normalisers, the epoch sums, the teacher cache) is the data axis, and the
ranks of one model group decode the same stripe (`process_data_stripes`).
`model_mesh()` is the model axis, over which the frozen teacher is split
(parallel/tp.py). At M = 1 the data axis is the mesh itself and every
path is the 1-D mesh's.

`make_mesh` reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
MASTER_PORT, or takes an explicit `init_method` (tests use file:// in a
temporary directory). NCCL on CUDA, gloo on the CPU; gloo on CUDA only when
the caller asks for it (two ranks sharing one card, which NCCL refuses;
gloo takes the CUDA tensors as they are, checked on an H100 with torch
2.11). The groups have a timeout, so a collective that hangs raises.
Without a process group (no torchrun environment, no init_method) the mesh
is one device and every collective here is the identity.
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
    """A mesh of ranks, or one axis of it: this process's coordinate
    (`rank`) and the axis size (`world_size`), its device and its process
    group (None where the axis is one rank, or at world size 1 without a
    group). `ranks` are the group's members' global ranks in group order
    (None: 0..world_size-1, the whole world). A 2-D mesh (model_size > 1)
    holds its two axes, `data_axis()` and `model_axis()`, each a Mesh with
    its own collective counts; at model_size 1 the data axis is the mesh
    itself."""

    config: MeshConfig
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]
    group: Optional[object] = None
    # Collective calls, bytes and host seconds since the last reset.
    counts: Dict[str, float] = field(default_factory=lambda: {"calls": 0, "bytes": 0,
                                                               "seconds": 0.0})
    model_size: int = 1
    ranks: Optional[Tuple[int, ...]] = None
    axes: Dict[str, "Mesh"] = field(default_factory=dict, repr=False)

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def data_axis(self) -> "Mesh":
        """The data axis: this mesh itself at model_size 1."""
        return self.axes.get("data", self)

    def model_axis(self) -> Optional["Mesh"]:
        """The model axis (None at model_size 1)."""
        return self.axes.get("model")

    def global_rank(self, r: int) -> int:
        """The global rank of this group's rank r."""
        return self.ranks[r] if self.ranks is not None else r

    def reset_counts(self) -> None:
        for m in (self, *self.axes.values()):
            m.counts.update(calls=0, bytes=0, seconds=0.0)

    def axis_counts(self) -> Dict[str, Dict[str, float]]:
        """The counts by axis: "world" (collectives over every rank), and
        on a 2-D mesh "data" and "model"."""
        return {"world": dict(self.counts), **{k: dict(v.counts) for k, v in self.axes.items()}}


def check_model_parallel(config: MeshConfig, world_size: int) -> None:
    """The JAX package's check (lmsu_tpu/parallel/mesh.py::make_mesh):
    model_parallel must divide the number of devices (here ranks)."""
    mp = config.model_parallel
    if mp < 1:
        raise ValueError(f"model_parallel={mp} must be >= 1")
    if world_size % mp:
        raise ValueError(f"model_parallel={mp} does not divide {world_size} devices")


def check_mesh_config(config: MeshConfig, world_size: int) -> None:
    """model_parallel must divide the world size; num_devices, when set,
    must be the world size."""
    check_model_parallel(config, world_size)
    if config.num_devices is not None and config.num_devices != world_size:
        raise ValueError(f"MeshConfig.num_devices={config.num_devices} but the process group "
                         f"has {world_size} ranks (one device a rank)")


def mesh_layout(world_size: int, model_parallel: int) -> Dict[str, List[List[int]]]:
    """The data-major layout of `world_size` ranks: {"data": each data
    group's ranks (same model coordinate m, by d), "model": each model
    group's (same data coordinate d, by m)}; rank = d * model_parallel + m."""
    M = model_parallel
    D = world_size // M
    return {"data": [[d * M + m for d in range(D)] for m in range(M)],
            "model": [[d * M + m for m in range(M)] for d in range(D)]}


def _axis_groups(mesh: "Mesh", backend: str, timeout_s: float) -> None:
    """Build every data group and every model group on this rank (all ranks
    call new_group for all groups, in the same order) and attach this
    rank's two axes to `mesh`. A group of one rank is not made."""
    # (this rank's coordinate on the axis, the index of its group)
    coords = {"data": (mesh.data_rank, mesh.model_rank),
              "model": (mesh.model_rank, mesh.data_rank)}
    for axis, groups in mesh_layout(mesh.world_size, mesh.model_size).items():
        pos, which = coords[axis]
        for i, ranks in enumerate(groups):
            g = (dist.new_group(ranks, timeout=datetime.timedelta(seconds=timeout_s),
                                backend=backend) if len(ranks) > 1 else None)
            if i == which:
                mesh.axes[axis] = Mesh(mesh.config, pos, len(ranks), mesh.device, mesh.backend,
                                       group=g, ranks=tuple(ranks))


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
    """The mesh of this process, made active (BatchNorm, the fused blocks
    and the loaders read its data axis, the teacher its model axis).

    Rank and world size come from the arguments, else from torchrun's RANK
    and WORLD_SIZE. A process group is made when an init_method is given or
    WORLD_SIZE is set (env://, MASTER_ADDR / MASTER_PORT); else the mesh is
    this one device with no group. The device is cuda:LOCAL_RANK unless
    `device` names another (the CPU for tests); a CUDA device without CUDA
    raises, and there is no fallback. `backend` defaults to nccl on CUDA and
    gloo on the CPU. With config.model_parallel = M > 1 the ranks form
    the data-major 2-D mesh and every data and model group is made here."""
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
        mesh = Mesh(config, 0, 1, dev, None, model_size=config.model_parallel)
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
                group=dist.group.WORLD, model_size=config.model_parallel)
    if mesh.model_size > 1:
        _axis_groups(mesh, backend, timeout_s)
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


def spanning(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """`mesh` (default: the active one) when it spans more than one rank,
    else None."""
    m = mesh if mesh is not None else _ACTIVE
    return m if m is not None and m.world_size > 1 else None


def data_mesh() -> Optional[Mesh]:
    """The data axis of the active mesh when it spans more than one rank,
    else None: the layers that reduce over the data axis do nothing else
    at one rank. On a 1-D mesh the data axis is the mesh itself."""
    m = _ACTIVE
    return spanning(m.data_axis()) if m is not None else None


def model_mesh(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The model axis of `mesh` (default: the active one) when it has more
    than one rank, else None: the teacher's collectives under tp and sp."""
    m = mesh if mesh is not None else _ACTIVE
    return spanning(m.model_axis()) if m is not None and m.model_axis() is not None else None


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
    """(num_stripes, stripe_index) of this process: (D, rank // M) on the
    (D, M) mesh, (world_size, rank) on the 1-D mesh. The M ranks of one
    model group decode the same stripe, as in the JAX package when the
    model axis spans processes (lmsu_tpu/parallel/mesh.py:71-110). Feed it
    to make_loader(num_shards=..., shard_index=...)."""
    m = mesh if mesh is not None else _ACTIVE
    return (m.data_size, m.data_rank) if m is not None else (1, 0)


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


def all_gather(t: torch.Tensor, mesh: Optional[Mesh] = None, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (same shape on each) concatenated on `dim`, in rank
    order; t itself at world size 1."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return t
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(m.world_size)]

    def gather(ts):
        dist.all_gather(ts[1:], ts[0], group=m.group)
    _run(m, gather, [t] + outs)
    return torch.cat(outs, dim)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               mesh: Optional[Mesh] = None) -> None:
    """Overwrite `tensors` in place with those of the mesh's rank `src` (a
    rank of its group; the counterpart of replicate: parameters and buffers
    at start-up): one broadcast of them all, flattened, a dtype and device
    each."""
    m = mesh if mesh is not None else data_mesh()
    if m is None or m.world_size == 1:
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        if t.numel():
            groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            _run(m, lambda xs: dist.broadcast(xs[0], m.global_rank(src), group=m.group), [flat])
            for t, f in zip(ts, flat.split([t.numel() for t in ts])):
                t.detach().copy_(f.view_as(t))


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
