"""Teacher partitioning over the mesh: the fsdp (ZeRO-3 style) teacher.

Counterpart of the data-axis half of lmsu_tpu/parallel/tp.py. FSDP shards
only the frozen teacher's STORAGE over the data axis: each rank keeps one
slice of every leaf, and the leaves are gathered whole just before the
module that uses them runs, then freed. In JAX the placement rule is all
there is (GSPMD inserts the gather on use); here the rule is the same
(`fsdp_shardings`, JAX `_fsdp_leaf_spec`: the largest dim that the world
size divides, no carve-out for the classifier, replicated when none
divides) and the gather is placed by hand (`shard_teacher_fsdp`): a forward
pre-hook on each top-level module of the teacher all-gathers its leaves
and a forward hook frees them. Each rank computes the full-width teacher
on its own rows, so the outputs equal the replicated teacher's exactly;
per-rank teacher bytes between forwards drop by about the world size.

Tensor (channel) and spatial partitioning over a model axis need a 2-D
mesh, which the port does not have yet (MeshConfig.model_parallel > 1 is
refused): `tp_axis` is None on the 1-D mesh, as in the JAX package, where
KDConfig's default "tp" then means a replicated teacher.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from lmsu_tpu_torch.parallel.mesh import Mesh, _run, active


def tp_axis(mesh: Optional[Mesh] = None) -> Optional[str]:
    """The model axis name if the mesh has one of size > 1, else None (the
    port's mesh is 1-D: always None)."""
    m = mesh if mesh is not None else active()
    if m is not None and m.config.model_parallel > 1:
        return m.config.model_axis
    return None


def fsdp_dim(shape: Sequence[int], axis_size: int) -> Optional[int]:
    """The dim of a leaf of `shape` that fsdp shards over `axis_size`
    ranks: the largest that axis_size divides (the first of equal ones), or
    None (replicated) when none does, for a scalar, or at one rank."""
    if axis_size == 1 or not shape:
        return None
    divisible = [d for d, s in enumerate(shape) if s and s % axis_size == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda d: shape[d])


def fsdp_shardings(tensors: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                   world_size: int) -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} of every parameter and buffer (a module's
    state dict names) under fsdp over `world_size` ranks. The torch layouts
    order a leaf's dims differently from flax's, so where two dims of equal
    size qualify the one picked may differ from JAX's; its size, and so each
    rank's bytes, do not."""
    n = world_size
    items = (tensors.state_dict(keep_vars=True) if isinstance(tensors, torch.nn.Module)
             else tensors)
    return {k: fsdp_dim(tuple(v.shape), n) for k, v in items.items()}


@dataclass
class _Leaf:
    tensor: torch.Tensor
    dim: int
    local: torch.Tensor


@dataclass
class FsdpShards:
    """The sharded teacher's bookkeeping: per hooked module, its sharded
    leaves; the bytes of the whole teacher and of one rank's storage."""

    mesh: Mesh
    units: Dict[int, List[_Leaf]] = field(default_factory=dict)
    handles: list = field(default_factory=list)
    bytes_full: int = 0
    bytes_per_rank: int = 0
    gathers: int = 0

    def gather(self, unit: int) -> None:
        """Every sharded leaf of `unit` whole again (one all-gather each)."""
        m = self.mesh
        for leaf in self.units[unit]:
            parts = [torch.empty_like(leaf.local) for _ in range(m.world_size)]

            def run(ts, leaf=leaf):
                dist.all_gather(ts[1:], ts[0], group=m.group)
            _run(m, run, [leaf.local] + parts)
            leaf.tensor.data = torch.cat(parts, dim=leaf.dim)
            self.gathers += 1

    def release(self, unit: int) -> None:
        for leaf in self.units[unit]:
            leaf.tensor.data = leaf.local.new_empty(0)


def _leaves(module: torch.nn.Module, recurse: bool) -> List[torch.Tensor]:
    mods = module.modules() if recurse else [module]
    out, seen = [], set()
    for m in mods:
        for t in list(m._parameters.values()) + list(m._buffers.values()):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def shard_teacher_fsdp(teacher: torch.nn.Module, mesh: Optional[Mesh] = None
                       ) -> Optional[FsdpShards]:
    """Shard a frozen teacher's storage over the mesh's ranks in place.

    Each rank keeps its slice (`fsdp_dim`) of every leaf; the hooked units
    are each model's top-level modules (an ensemble's members' too), and
    the leaves a model holds itself ride on the model's own hooks. Returns
    the bookkeeping, or None at world size 1 (the teacher stays whole, as
    JAX's fsdp_shardings replicates on one device)."""
    m = mesh if mesh is not None else active()
    if m is None or m.world_size == 1:
        return None
    if any(p.requires_grad for p in teacher.parameters()):
        raise ValueError("shard_teacher_fsdp shards a frozen teacher (requires_grad False)")
    shards = FsdpShards(m)
    roots = list(teacher.members) if hasattr(teacher, "members") else [teacher]
    units: List[Tuple[torch.nn.Module, List[torch.Tensor]]] = []
    for root in roots:
        units += [(child, _leaves(child, True)) for child in root.children()]
        units.append((root, _leaves(root, False)))
    for mod, tensors in units:
        leaves = []
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            shards.bytes_full += nbytes
            d = fsdp_dim(tuple(t.shape), m.world_size)
            if d is None:
                shards.bytes_per_rank += nbytes
                continue
            local = t.detach().chunk(m.world_size, dim=d)[m.rank].clone()
            shards.bytes_per_rank += local.numel() * local.element_size()
            leaves.append(_Leaf(t, d, local))
        if not leaves:
            continue
        key = len(shards.units)
        shards.units[key] = leaves
        shards.handles.append(mod.register_forward_pre_hook(
            lambda *_, key=key: shards.gather(key)))
        shards.handles.append(mod.register_forward_hook(
            lambda *_, key=key: shards.release(key)))
        shards.release(key)
    return shards
