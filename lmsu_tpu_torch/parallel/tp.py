"""Teacher partitioning over the mesh: fsdp over the data axis, tp and sp
over the model axis.

Counterpart of lmsu_tpu/parallel/tp.py and of the teacher placement of
lmsu_tpu/training/distill.py:183-225. In JAX each partition is a placement
rule and GSPMD inserts the collectives; here the rule is the same and the
collectives are placed by hand. The student is never split: it is
data-parallel over the data axis and replicated along the model axis
(parallel/mesh.py). Every rule leaves the teacher's outputs those of the
whole teacher, up to the order of f32 sums.

fsdp (ZeRO-3 style, `fsdp_shardings`, `shard_teacher_fsdp`) shards only
the frozen teacher's STORAGE over the DATA axis (JAX `_fsdp_leaf_spec`:
the largest dim that the axis size divides, no carve-out for the
classifier, replicated when none divides): a forward pre-hook on each
top-level module of the teacher all-gathers its leaves and a forward hook
frees them. Each rank computes the full-width teacher on its own rows, so
the outputs equal the replicated teacher's exactly.

tp (`tp_shardings`, `shard_teacher_tp`) splits the teacher's COMPUTE by
channel over the model axis, JAX `_leaf_spec` carried through the torch
layouts: every conv, Conv1d and dense weight is split on dim 0 (flax's
trailing dim: the output channels, and the INPUT channels of a transposed
conv, whose flax kernel is [kh, kw, O, I]); every 1-D channel vector (conv
bias, BN weight / bias / running statistics) likewise; a leaf with "cls"
in its name, a scalar, or one whose dim 0 the axis does not divide stays
whole. The forward (`TensorParallelTeacher`) follows GSPMD's plan for
those weights, with each activation marked split (rank m holds channels
[m C/M, (m+1) C/M)) or whole:
  * channel-local ops keep a split activation split: eval BatchNorm,
    ReLU / ReLU6 / Sigmoid, depthwise convs (their groups become the local
    C), residual adds, the bilinear resize, and K1's scatter-max, which is
    exact on a channel slice;
  * an op that contracts over channels takes its input whole, all-gathered
    over the model group along C where it is split: a dense 1x1 or 3x3
    conv, a Conv1d, a softmax over channels, indexing a channel of the
    gate, K2 (its weights gathered too), a fused K3 block (its weights
    gathered too; its output stays whole, as GSPMD leaves a pallas_call
    that has no partition rule, so the next contraction needs no gather),
    and the KD projection and K7 (the taps are returned whole);
  * a transposed conv split on its input channels multiplies its split
    input by its slice and all-reduces the partial sums (whole output);
  * a leaf left whole gives a whole output, which is never gathered
    again, and a whole activation meeting a split leaf is sliced locally.
The concat fusion gathers both projections before the concat: the
concatenation of two split tensors is [cam_m, lid_m], which is not rank
m's slice of [cam, lid] that the following depthwise conv's weight slice
assumes. The weighted fusion's fused gate (K2) gets its weights gathered:
`attention.{0,2}` are Cout-split by the rule. The gathers of one forward
are counted (`TensorParallelTeacher.gathers`): for the weighted/128 2x
teacher (spatial LiDAR encoder, same-resolution head) 22 activation
gathers and 1 weight gather per forward (K2's four leaves in one), for
concat/256's 2x teacher 24 activation gathers.

sp (`SpatialTeacher`) splits the teacher's camera encoder by image rows
over the model axis: rank m takes rows [m H/M, (m+1) H/M) of its stripe's
images (uint8 sliced before the cast). The stem and stages 1-5 run
H-split, each 3x3 conv fed a one-row halo over the model group from the
rank above (and, at stride 1, from the rank below), zero rows at the
global top and bottom only. The halo is taken from the tensor the 3x3
conv reads: inside an InvertedResidual that is the expanded, post-ReLU6
tensor, so a zero row at a global edge is the conv's own zero padding
(the block's input rows would need the expansion, BN and ReLU6 first, and
at an edge a zero after the activation, not ReLU6(BN(expand(0)))). A
stride-2 conv on a shard that starts at an even row reads rows 2o-1..2o+1
for its output row o: one row from above, none from below. A
fused_inference block runs K3 on the whole H: its input all-gathered
along H, its output sliced back. After stage 5 the multi-scale maps are
all-gathered along H and the FPN, the LiDAR path, the fusion and the head
run whole on every rank of the model group. GSPMD would keep them split
further; that is a difference of placement, not of result. A forward
makes 6 halo exchanges and 4 gathers (one more a fused block). The split
needs H / M to be a multiple of the encoder's total stride, 8
(`check_sp_height`).

`tp_axis` is the model axis when the mesh has one of size > 1, else None;
KDConfig's default "tp" then means a replicated teacher, as in JAX.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lmsu_tpu_torch.parallel.mesh import Mesh, _run, active, all_gather, all_reduce_, model_mesh

def tp_axis(mesh: Optional[Mesh] = None) -> Optional[str]:
    """The model axis name if the mesh (default: the active one) has one of
    size > 1, else None."""
    m = mesh if mesh is not None else active()
    if m is not None and m.model_size > 1:
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


# -- tp: the channel-split teacher ---------------------------------------------


def tp_dim(name: str, shape: Sequence[int], axis_size: int) -> Optional[int]:
    """The dim of the leaf `name` of `shape` that tp splits over
    `axis_size` ranks (JAX `_leaf_spec` in the torch layouts): 0, or None
    (whole) for a scalar, a leaf of the classifier ("cls" in its name), a
    dim 0 that axis_size does not divide, or one rank."""
    if axis_size == 1 or not shape or "cls" in name.split("."):
        return None
    return 0 if shape[0] % axis_size == 0 else None


def tp_shardings(tensors: Union[nn.Module, Mapping[str, torch.Tensor]],
                 axis_size: int) -> Dict[str, Optional[int]]:
    """{state-dict name: split dim or None} of every parameter and buffer
    under tp over `axis_size` ranks."""
    items = (tensors.state_dict(keep_vars=True) if isinstance(tensors, nn.Module)
             else tensors)
    return {k: tp_dim(k, tuple(v.shape), axis_size) for k, v in items.items()}


@dataclass
class TPShards:
    """The split teacher's bookkeeping: the bytes of the whole teacher and
    of one rank's leaves, and the tp members (one, or an ensemble's)."""

    mesh: Mesh
    bytes_full: int = 0
    bytes_per_rank: int = 0
    members: List["TensorParallelTeacher"] = field(default_factory=list)

    @property
    def gathers(self) -> int:
        """The model-axis gathers of the members' last forwards."""
        return sum(t.gathers for t in self.members)


def _split_leaves(model: nn.Module, mm: Mesh, shards) -> List[torch.Tensor]:
    """Keep rank mm.rank's slice of every leaf `tp_shardings` splits, in
    place; the split leaves, and the bytes counted into `shards`."""
    split = []
    for name, t in model.state_dict(keep_vars=True).items():
        nbytes = t.numel() * t.element_size()
        shards.bytes_full += nbytes
        if tp_dim(name, tuple(t.shape), mm.world_size) is None:
            shards.bytes_per_rank += nbytes
            continue
        t.data = t.data.chunk(mm.world_size, 0)[mm.rank].clone()
        shards.bytes_per_rank += t.numel() * t.element_size()
        split.append(t)
    return split


def _on_members(teacher: nn.Module, wrap) -> nn.Module:
    """wrap(member) for the teacher or each of an ensemble's members."""
    if hasattr(teacher, "members"):
        for i, member in enumerate(teacher.members):
            teacher.members[i] = wrap(member)
        return teacher
    return wrap(teacher)


def shard_teacher_tp(teacher: nn.Module, mesh: Optional[Mesh] = None
                     ) -> Tuple[nn.Module, Optional[TPShards]]:
    """Split a frozen teacher by channel over the mesh's model axis, in
    place: (the teacher to call, whose forward places the gathers; the
    bookkeeping). Without a model axis of more than one rank the teacher
    comes back whole with None. An ensemble's members are split each."""
    mm = model_mesh(mesh)
    if mm is None:
        return teacher, None
    if any(p.requires_grad for p in teacher.parameters()):
        raise ValueError("shard_teacher_tp splits a frozen teacher (requires_grad False)")
    shards = TPShards(mm)

    def wrap(member):
        t = TensorParallelTeacher(member, mm, _split_leaves(member, mm, shards))
        shards.members.append(t)
        return t
    return _on_members(teacher, wrap), shards


class _Act(NamedTuple):
    """An activation [B, C, ...]: whole, or split by channel (rank m holds
    channels [m C/M, (m+1) C/M))."""

    t: torch.Tensor
    split: bool


class TensorParallelTeacher(nn.Module):
    """A teacher whose leaves are split by `shard_teacher_tp` over the model
    group `mm`, run as the module docstring's tp plan. Same call and
    outputs as the model's (logits NHWC and NCHW taps, all whole)."""

    def __init__(self, model: nn.Module, mm: Mesh, split: Sequence[torch.Tensor]):
        super().__init__()
        self.model = model
        self.mm = mm
        self._split = {id(t) for t in split}
        self.gathers = 0

    # -- collectives -----------------------------------------------------------

    def _is_split(self, t: Optional[torch.Tensor]) -> bool:
        return t is not None and id(t) in self._split

    def whole(self, a: _Act) -> torch.Tensor:
        """a whole: all-gathered over the model group along C if split."""
        if not a.split:
            return a.t
        self.gathers += 1
        return all_gather(a.t.contiguous(), self.mm, dim=1)

    def local(self, a: _Act) -> torch.Tensor:
        """Rank m's channel slice of a (a view when a is whole)."""
        return a.t if a.split else a.t.chunk(self.mm.world_size, 1)[self.mm.rank]

    @contextlib.contextmanager
    def whole_leaves(self, module: nn.Module):
        """Inside, every split leaf of `module` is whole (all-gathered along
        dim 0; one gather for all of them, counted as one); after it, each
        holds its slice again."""
        leaves = [t for t in list(module.parameters()) + list(module.buffers())
                  if self._is_split(t)]
        if not leaves:
            yield
            return
        local = [t.data for t in leaves]
        flat = torch.cat([t.reshape(-1) for t in local])
        self.gathers += 1
        full = all_gather(flat, self.mm).view(self.mm.world_size, -1)
        off = 0
        for t, lo in zip(leaves, local):
            n = lo.numel()
            t.data = full[:, off:off + n].reshape(-1, *lo.shape[1:])
            off += n
        try:
            yield
        finally:
            for t, lo in zip(leaves, local):
                t.data = lo

    # -- layers ----------------------------------------------------------------

    def layer(self, mod: nn.Module, a: _Act) -> _Act:
        """One layer of a Sequential, in a's dtype (as models/layers.py's
        apply_seq runs it)."""
        dt = a.t.dtype
        if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            conv = F.conv1d if isinstance(mod, nn.Conv1d) else F.conv2d
            split = self._is_split(mod.weight)
            if mod.groups > 1:  # depthwise: groups == in == out channels
                x = self.local(a) if split else self.whole(a)
                groups = x.shape[1]
            else:
                x, groups = self.whole(a), 1
            bias = None if mod.bias is None else mod.bias.to(dt)
            y = conv(x, mod.weight.to(dt), bias, mod.stride, mod.padding, mod.dilation, groups)
            return _Act(y, split)
        if isinstance(mod, nn.ConvTranspose2d):
            if self._is_split(mod.weight):  # split on its input channels: partial sums
                assert mod.bias is None and mod.groups == 1
                y = F.conv_transpose2d(self.local(a), mod.weight.to(dt), None, mod.stride,
                                       mod.padding, mod.output_padding, 1, mod.dilation)
                return _Act(all_reduce_(y.contiguous(), mesh=self.mm), False)
            bias = None if mod.bias is None else mod.bias.to(dt)
            return _Act(F.conv_transpose2d(self.whole(a), mod.weight.to(dt), bias, mod.stride,
                                           mod.padding, mod.output_padding, mod.groups,
                                           mod.dilation), False)
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            split = self._is_split(mod.running_mean)
            return _Act(mod(self.local(a) if split else self.whole(a)), split)
        if isinstance(mod, (nn.ReLU, nn.ReLU6, nn.Sigmoid)):
            return _Act(mod(a.t), a.split)
        if isinstance(mod, nn.Softmax):
            return _Act(mod(self.whole(a)), False)
        raise NotImplementedError(f"tp: no plan for {type(mod).__name__}")

    def seq(self, mods, a: _Act) -> _Act:
        for mod in mods:
            a = self.layer(mod, a)
        return a

    def add(self, a: _Act, b: _Act) -> _Act:
        """a + b; where one side is split, the whole one is sliced."""
        if a.split == b.split:
            return _Act(a.t + b.t, a.split)
        return _Act(self.local(a) + self.local(b), True)

    def inverted_residual(self, blk: nn.Module, a: _Act) -> _Act:
        if blk.fused_inference and not blk.training:
            x = self.whole(a)
            with self.whole_leaves(blk):
                return _Act(blk(x), False)
        y = self.seq(blk.conv, a)
        return self.add(a, y) if blk.use_residual else y

    # -- the model -------------------------------------------------------------

    def encoder(self, enc: nn.Module, x: torch.Tensor):
        a = self.seq(enc.stem, _Act(x, False))
        outs = {}
        for s in ("stage1", "stage2", "stage3", "stage4", "stage5"):
            a = self.inverted_residual(getattr(enc, s), a)
            outs[s] = a
        if enc.config.return_multiscale:
            return {s: outs[s] for s in ("stage2", "stage3", "stage4", "stage5")}
        return a

    def fpn(self, fpn: nn.Module, feats: Dict[str, _Act]) -> _Act:
        from lmsu_tpu_torch.ops.resize import resize_bilinear
        hw = max((tuple(feats[s].t.shape[-2:]) for s in fpn.stages),
                 key=lambda x: x[0] * x[1])
        fused = None
        for s in fpn.stages:
            y = self.seq(fpn.laterals[s].conv, feats[s])
            y = _Act(resize_bilinear(y.t, hw), y.split)
            fused = y if fused is None else self.add(fused, y)
        return self.seq(fpn.post.net, fused)

    def lidar(self, lidar: nn.Module, points, point_valid, dt) -> _Act:
        from lmsu_tpu_torch.models.lidar_encoder import _scatter
        enc = lidar.encoder
        feats, flat_idx, valid = enc.point_inputs(points, point_valid, dt)
        x = self.seq(enc.mlp, _Act(feats.transpose(1, 2), False))
        bev = _scatter(enc.config, x.t.transpose(1, 2).contiguous(), flat_idx, valid)
        return _Act(bev.permute(0, 3, 1, 2), x.split)

    def fusion(self, fusion: nn.Module, cam: _Act, lid: _Act) -> Tuple[_Act, _Act]:
        from lmsu_tpu_torch.models.fusion import (ConcatenationFusion, MinimalFusion,
                                                  WeightedFusion)
        from lmsu_tpu_torch.ops.fusion_gate import fusion_gate
        if isinstance(fusion, ConcatenationFusion):
            c = self.seq(fusion.camera_proj.conv, cam)
            li = self.seq(fusion.lidar_proj.conv, lid)
            pre = _Act(torch.cat([self.whole(c), self.whole(li)], 1), False)
            return pre, self.seq(fusion.fuse, pre)
        c = self.seq(fusion.cam_proj.conv, cam)
        li = self.seq(fusion.lidar_proj.conv, lid)
        if isinstance(fusion, MinimalFusion):
            fused = self.add(c, li)
            return fused, fused
        assert isinstance(fusion, WeightedFusion), type(fusion)
        if fusion.use_fused_gate:
            cw, lw = self.whole(c), self.whole(li)
            a0, a2 = fusion.attention[0], fusion.attention[2]
            with self.whole_leaves(fusion.attention):
                out = fusion_gate(cw.permute(0, 2, 3, 1), lw.permute(0, 2, 3, 1),
                                  a0.weight, a0.bias, a2.weight, a2.bias)
            fused = _Act(out.permute(0, 3, 1, 2), False)
            return fused, fused
        if c.split != li.split:
            c, li = _Act(self.whole(c), False), _Act(self.whole(li), False)
        w = self.whole(self.seq(fusion.attention,
                                _Act(torch.cat([self.whole(c), self.whole(li)], 1), False)))
        fused = _Act(c.t * w[:, 0:1] + li.t * w[:, 1:2], c.split)
        return fused, fused

    def head(self, head: nn.Module, a: _Act) -> torch.Tensor:
        from lmsu_tpu_torch.models.fusion import LightweightSegmentationHead
        if isinstance(head, LightweightSegmentationHead):
            a = self.seq(head.up2, self.seq(head.up1, a))
        else:
            for b in head.block:
                a = self.seq(b.net, a)
        return self.whole(self.layer(head.cls, a))

    def forward(self, images: torch.Tensor, points: torch.Tensor,
                point_valid: Optional[torch.Tensor] = None, return_intermediates: bool = False):
        from lmsu_tpu_torch.ops.resize import resize_bilinear
        model = self.model
        self.gathers = 0
        dt = model.config.compute_dtype
        if images.dtype == torch.uint8:
            images = images.to(dt) / 255.0
        cam_raw = self.encoder(model.camera_encoder, images.to(dt).permute(0, 3, 1, 2))
        cam = self.fpn(model.camera_fpn, cam_raw) if model.camera_fpn is not None else cam_raw
        # The taps are returned whole: gathered once, and the fusion reads them whole.
        cam = _Act(self.whole(cam), False)
        lid = _Act(self.whole(self.lidar(model.lidar_encoder, points, point_valid, dt)), False)
        if cam.t.shape[-2:] != lid.t.shape[-2:]:
            lid = _Act(resize_bilinear(lid.t, tuple(cam.t.shape[-2:])), False)
        pre, fused = self.fusion(model.fusion, cam, lid)
        pre_t = self.whole(pre)
        fused_t = pre_t if fused is pre else self.whole(fused)
        logits = self.head(model.head, _Act(fused_t, False) if fused is pre else fused)
        logits = logits.permute(0, 2, 3, 1).contiguous()
        if return_intermediates:
            return logits, {"camera_feat": cam.t, "lidar_feat": lid.t, "pre_fusion": pre_t,
                            "post_fusion": fused_t, "logits": logits}
        return logits


# -- sp: the teacher's camera encoder split by image rows ------------------------

SP_STRIDE = 8  # the camera encoder's total stride (stem, stage 2, stage 4)


def check_sp_height(height: int, model_parallel: int) -> None:
    """sp splits the image rows over the model axis: H / M rows a rank must
    be a multiple of the encoder's total stride, 8. ValueError otherwise."""
    if height % model_parallel or (height // model_parallel) % SP_STRIDE:
        raise ValueError(
            f"teacher_partition='sp': image height {height} over model_parallel="
            f"{model_parallel} gives {height / model_parallel:g} rows a rank, not a multiple "
            f"of the camera encoder's total stride {SP_STRIDE}")


@dataclass
class SPShards:
    """The row-split teacher's bookkeeping: its members, the halo
    exchanges and the H gathers of their last forwards."""

    mesh: Mesh
    members: List["SpatialTeacher"] = field(default_factory=list)

    @property
    def halos(self) -> int:
        return sum(t.halos for t in self.members)

    @property
    def gathers(self) -> int:
        return sum(t.gathers for t in self.members)


def shard_teacher_sp(teacher: nn.Module, mesh: Optional[Mesh] = None
                     ) -> Tuple[nn.Module, Optional[SPShards]]:
    """The teacher (or each of an ensemble's members) with its camera
    encoder split by image rows over the model axis; its weights stay
    whole. Without a model axis of more than one rank: (teacher, None)."""
    mm = model_mesh(mesh)
    if mm is None:
        return teacher, None
    shards = SPShards(mm)

    def wrap(member):
        t = SpatialTeacher(member, mm)
        shards.members.append(t)
        return t
    return _on_members(teacher, wrap), shards


class SpatialTeacher(nn.Module):
    """A whole teacher whose camera encoder runs split by image rows over
    the model group `mm`, as the module docstring's sp plan."""

    def __init__(self, model: nn.Module, mm: Mesh):
        super().__init__()
        self.model = model
        self.mm = mm
        self.halos = 0
        self.gathers = 0

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, h, W] of each rank, stacked along H in rank order."""
        self.gathers += 1
        return all_gather(x.contiguous(), self.mm, dim=2)

    def halo(self, x: torch.Tensor, below: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the row above this rank's first, the row below its last when
        `below`) from its neighbours; zero rows at the global top and
        bottom. One all-gather of every rank's edge rows."""
        M, m = self.mm.world_size, self.mm.rank
        edges = torch.cat([x[:, :, :1], x[:, :, -1:]], 2).contiguous()
        self.halos += 1
        parts = all_gather(edges, self.mm, dim=0).chunk(M, 0)
        zero = torch.zeros_like(x[:, :, :1])
        top = parts[m - 1][:, :, 1:2] if m > 0 else zero
        bottom = (parts[m + 1][:, :, 0:1] if m < M - 1 else zero) if below else None
        return top, bottom

    def conv(self, mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = mod.weight.to(x.dtype)
        bias = None if mod.bias is None else mod.bias.to(x.dtype)
        if mod.kernel_size[0] == 1:
            return F.conv2d(x, w, bias, mod.stride, mod.padding, mod.dilation, mod.groups)
        assert mod.kernel_size == (3, 3) and mod.padding == (1, 1), mod
        top, bottom = self.halo(x, below=mod.stride[0] == 1)
        x = torch.cat([top, x] + ([bottom] if bottom is not None else []), 2)
        return F.conv2d(x, w, bias, mod.stride, (0, 1), mod.dilation, mod.groups)

    def seq(self, mods, x: torch.Tensor) -> torch.Tensor:
        for mod in mods:
            x = self.conv(mod, x) if isinstance(mod, nn.Conv2d) else mod(x)
        return x

    def inverted_residual(self, blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if blk.fused_inference and not blk.training:
            y = blk(self.gather_rows(x))
            h = y.shape[2] // self.mm.world_size
            return y[:, :, self.mm.rank * h:(self.mm.rank + 1) * h]
        y = self.seq(blk.conv, x)
        return x + y if blk.use_residual else y

    def forward(self, images: torch.Tensor, points: torch.Tensor,
                point_valid: Optional[torch.Tensor] = None, return_intermediates: bool = False):
        model = self.model
        enc = model.camera_encoder
        M, m = self.mm.world_size, self.mm.rank
        self.halos = self.gathers = 0
        check_sp_height(images.shape[1], M)
        h = images.shape[1] // M
        dt = model.config.compute_dtype
        rows = images[:, m * h:(m + 1) * h]
        if rows.dtype == torch.uint8:
            rows = rows.to(dt) / 255.0
        x = self.seq(enc.stem, rows.to(dt).permute(0, 3, 1, 2))
        outs = {}
        for s in ("stage1", "stage2", "stage3", "stage4", "stage5"):
            x = self.inverted_residual(getattr(enc, s), x)
            outs[s] = x
        if enc.config.return_multiscale:
            cam_raw = {s: self.gather_rows(outs[s])
                       for s in ("stage2", "stage3", "stage4", "stage5")}
        else:
            cam_raw = self.gather_rows(x)
        return model.forward_from_encoder(cam_raw, points, point_valid, return_intermediates)
