"""Training runtime: the train/eval steps and the epoch loop, on one device.

Counterpart of lmsu_tpu/training/trainer.py (reference trainer.py:40-194):
forward + weighted CE + backward + AdamW (+ optional global-norm clipping
and EMA) per batch, the confusion matrix on the device, the epoch-stepped
cosine LR, best-mIoU tracking, latest/best checkpoints and
training_history.json with the reference schema.

AdamW has `optax.adamw` semantics: b1 0.9, b2 0.999, eps 1e-8 added to
sqrt(v_hat), decoupled decay on EVERY parameter (the reference decays BN
affine too, trainer.py:56), and the LR of step k is schedule(k), read at
the pre-update count. torch.optim.AdamW with the LR set before each step
computes the same update. A parameter that gets no gradient gets a zero
gradient, as in optax, so its moments and decay still advance.

Loss and confusion matrix stay on the device during an epoch and are read
once at its end, so the loop does not wait on the device per step.

TrainConfig.augment runs inside the train step, on the batch on the
device, before the forward (ops/augment.py); its stream is keyed by the
step, so a resume and every loop below reproduce it. Validation is never
augmented.

The loops (the JAX package's trainer.py:348-620):
  * scan_steps = K > 1 (training and validation): K host batches are
    stacked into [K, B, ...] and copied to the device in one transfer
    (one pinned buffer), and K steps run on views of the chunk; fewer than
    K leftover batches at the epoch's end run one by one. The port runs
    eagerly, so a chunk runs the ops of K single steps in their order: on
    the CPU it is bit-identical to scan_steps = 1.
  * onchip_epoch: the training set (materialize_dataset, with the
    Batcher's sample_transform) is copied to the device once; each epoch
    draws a permutation of the padded count from SeedSequence([seed, epoch,
    104729]) and gathers each batch with index_select. onchip_contiguous
    permutes the set once an epoch with one gather and reads contiguous
    slices. onchip_eval (None: follow onchip_epoch where the val loader has
    a Batcher) does the same for validation, in order.
Run control (trainer.py:625-748): async_checkpoint (checkpoint.py::
AsyncCheckpointer), snapshot_every (epoch_###.pth), handle_sigterm and
request_preempt (stop after the current epoch, its checkpoint written and
flushed), debug_nans and progress (training/monitor.py).

Data parallelism (`mesh`, parallel/mesh.py; one process a device): each
rank's loader yields its stripe of every global batch; BatchNorm and the
fused blocks reduce their statistics over the mesh, the loss normalisers
are the global batch's (one all-reduce of three totals a step), and one
flat all-reduce sums the gradients (the projections' too) before clipping
and AdamW, so every rank takes the same update. Augmentation draws for the
global batch and keeps its own rows. The epoch's loss sums and confusion
matrix are reduced once at its end. Rank 0 alone writes checkpoints and
training_history.json; every rank restores the same file. A SIGTERM stop
is agreed by a max-reduce of the flag at the epoch's end. The on-device
epoch and validation are single-process, as in the JAX package.

On a 2-D (data, model) mesh (MeshConfig.model_parallel = M > 1) the
student is data-parallel over the data axis and replicated along the model
axis: the M ranks of one model group take the same stripe, and every
reduction above runs over the data axis only. The replicas must stay
identical bit for bit, and on the card they need not compute the same
gradient bits (the FPN's bilinear backward uses atomicAdd). So the
gradients are all-reduced over the data axis and then broadcast, with the
student's floating-point buffers (its BatchNorm running statistics), from
the rank of model coordinate 0 to the rest of its model group: one more
collective a step, and every rank of the group leaves the step with rank
0's bits. AdamW and the EMA then move identical parameters identically.
Rank 0 of the whole mesh writes the checkpoints.
"""

from __future__ import annotations

import signal
import threading
import time
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.config import ExperimentConfig
from lmsu_tpu_torch.data.pipeline import materialize_dataset
from lmsu_tpu_torch.inference import resolve_device
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.factory import check_kernel_shapes
from lmsu_tpu_torch.ops import augment
from lmsu_tpu_torch.ops.losses import LossTotals, global_loss_totals, weighted_cross_entropy
from lmsu_tpu_torch.ops.metrics import confusion_matrix, iou_from_confusion
from lmsu_tpu_torch.parallel.mesh import (Mesh, active, all_reduce_, broadcast_,
                                          check_mesh_config, model_mesh, spanning)
from lmsu_tpu_torch.training import checkpoint as ckpt
from lmsu_tpu_torch.training.monitor import NanGuard, ProgressBar
from lmsu_tpu_torch.training.schedule import cosine_epoch_schedule, lr_at_epoch
from lmsu_tpu_torch.utils.profiling import StallMeter

# The device dtype of each batch key (other keys stay on the host).
_BATCH_DTYPES = {"points": np.float32, "segmentation": np.int64, "point_valid": np.bool_,
                 "sample_mask": np.bool_, "sample_index": np.int64}


def check_train_config(config: ExperimentConfig, world_size: int = 1) -> None:
    """ValueError for a MeshConfig.model_parallel that does not divide the
    world size, or a MeshConfig.num_devices other than it."""
    check_mesh_config(config.mesh, world_size)


def to_device_packed(arrays: Dict[str, np.ndarray], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Host batch arrays (stacked or not) -> device tensors in the trainer's
    dtypes (_BATCH_DTYPES; images uint8, else float32) through ONE copy: the
    arrays are packed into one buffer (pinned for a CUDA device, 16-byte
    aligned slots) and each tensor is a view of the copy on the device."""
    host = {}
    for k, a in arrays.items():
        if k == "image":
            a = np.asarray(a)
            host[k] = a if a.dtype == np.uint8 else a.astype(np.float32, copy=False)
        elif k in _BATCH_DTYPES:
            host[k] = np.asarray(a).astype(_BATCH_DTYPES[k], copy=False)
    offsets, total = {}, 0
    for k, a in host.items():
        offsets[k] = total
        total += (a.nbytes + 15) // 16 * 16
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = buf.numpy()
    for k, a in host.items():
        flat[offsets[k]:offsets[k] + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = buf.to(device, non_blocking=True)
    return {k: dev[offsets[k]:offsets[k] + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for k, a in host.items()}


class _EpochSums:
    """Loss and confusion-matrix sums of an epoch, on the device, in step
    order; read once. Under data parallelism each rank holds its shares,
    summed over the mesh once, in finish()."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.total, self.cm, self.n = None, None, 0
        self.mesh = mesh

    def add(self, loss: torch.Tensor, cm: torch.Tensor) -> None:
        self.total = loss.float() if self.total is None else self.total + loss.float()
        self.cm = cm if self.cm is None else self.cm + cm
        self.n += 1

    def mean_loss(self) -> float:
        return float(self.total) / self.n if self.n else 0.0

    def finish(self, num_classes: int) -> Tuple[float, Dict]:
        if self.mesh is not None and self.mesh.world_size > 1 and self.n:
            self.total = all_reduce_(self.total.clone(), mesh=self.mesh)
            self.cm = all_reduce_(self.cm.clone(), mesh=self.mesh)
        cm = (self.cm.cpu().numpy() if self.cm is not None
              else np.zeros((num_classes, num_classes), np.int64))
        return self.mean_loss(), iou_from_confusion(cm)


def make_optimizer(config, params: Iterable[torch.Tensor], steps_per_epoch: int
                   ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over all `params` and its per-step LR schedule (the trainer
    writes schedule(step) into the optimizer before each step)."""
    schedule = cosine_epoch_schedule(config.lr, config.eta_min, config.num_epochs,
                                     steps_per_epoch)
    opt = torch.optim.AdamW(list(params), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)
    return opt, schedule


def clip_by_global_norm(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global L2 norm reaches
    max_norm, every gradient is scaled by max_norm / norm (no epsilon,
    unlike torch's clip_grad_norm_)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def update_ema(ema_decay: Optional[float], ema_params, new_params):
    """One EMA step in place, ema = d*ema + (1-d)*params (identity when
    disabled). Both are dicts of tensors with the same keys."""
    if ema_decay is None:
        return ema_params
    with torch.no_grad():
        for k, e in ema_params.items():
            e.mul_(ema_decay).add_(new_params[k].detach(), alpha=1.0 - ema_decay)
    return ema_params


class Trainer:
    """Epoch-loop orchestrator with the reference's external contract.

    Loaders yield batches of numpy arrays (data/pipeline.py): image uint8
    [B, H, W, 3], points [B, N, 4], segmentation [B, h, w], and optionally
    point_valid, sample_mask and sample_index. Runs on CUDA unless
    `device="cpu"` is asked for. `mesh` (parallel/mesh.py::make_mesh;
    default: the active mesh when it spans more than one rank) runs on the
    mesh's device, data-parallel over its data axis, each loader yielding
    this rank's stripe; a mesh of more than one rank must be the active
    one, and with none or one rank no other may be active. `world` and
    `rank` are the data axis's size and this rank's coordinate on it."""

    def __init__(self, config: ExperimentConfig, train_loader, val_loader, *,
                 device="cuda", model=None, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else spanning()
        self.dmesh = self.mesh.data_axis() if self.mesh is not None else None
        self.world = self.dmesh.world_size if self.dmesh is not None else 1
        self.rank = self.dmesh.rank if self.dmesh is not None else 0
        self.global_world = self.mesh.world_size if self.mesh is not None else 1
        self.is_writer = self.mesh is None or self.mesh.rank == 0
        self._check_mesh()
        check_train_config(config, self.global_world)
        augment.check_augment_compat(config.train.augment, config.model.lidar.scatter_impl,
                                     cache_teacher=config.train.kd.cache_teacher)
        self.device = resolve_device(self.mesh.device if self.mesh is not None else device)
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        tc = config.train
        self.model = (model if model is not None
                      else create_model(config.model, seed=tc.seed)).to(self.device)
        check_kernel_shapes(self.model, self.device)
        self.steps_per_epoch = max(1, len(train_loader))
        self.class_weights = (torch.tensor(tc.class_weights, dtype=torch.float32,
                                           device=self.device)
                              if tc.class_weights is not None else None)
        extra = self._init_extra_params()
        self.params = OrderedDict(
            [(f"model.{n}", p) for n, p in self.model.named_parameters()]
            + [(n, p) for n, p in extra.items()])
        # Rank 0's weights everywhere (the JAX package's replicate).
        broadcast_(list(self.params.values()) + list(self.model.buffers()), mesh=self.mesh)
        self.optimizer, self.schedule = make_optimizer(tc, self.params.values(),
                                                       self.steps_per_epoch)
        self.step = 0
        self.ema_params = ({k: p.detach().clone() for k, p in self.params.items()}
                           if tc.ema_decay is not None else None)
        self.best_miou = 0.0
        self.last_host_stall_frac = 0.0
        self.last_loss_parts_raw: Dict[str, torch.Tensor] = {}
        self.save_dir = tc.save_dir
        self.history = ckpt.HistoryWriter(self.save_dir, write=self.is_writer)
        self._epoch_index = 0
        self._preempt_requested = False
        self._async_ckpt: Optional[ckpt.AsyncCheckpointer] = None
        self._onchip_data: Optional[Dict[str, torch.Tensor]] = None
        self._onchip_val_data: Optional[Dict[str, torch.Tensor]] = None
        self._nan_guard = NanGuard(self._guarded_modules()) if tc.debug_nans else None

    def _guarded_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules debug_nans watches (the KD trainer adds its teacher)."""
        return {"model": self.model}

    def _init_extra_params(self) -> Dict[str, torch.nn.Parameter]:
        """Trainable parameters beside the model's (the KD projections)."""
        return {}

    # -- steps ---------------------------------------------------------------

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A batch (numpy arrays, or tensors on any device) on the device in
        the trainer's dtypes; tensors already there are not copied. Every
        step starts here, so the mesh is checked here too (_check_mesh)."""
        self._check_mesh()

        def t(a, dtype=None):
            a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device, dtype=dtype)
        out = {"image": t(batch["image"]), "points": t(batch["points"], torch.float32),
               "segmentation": t(batch["segmentation"], torch.long)}
        if out["image"].dtype != torch.uint8:
            out["image"] = out["image"].float()
        for k in ("point_valid", "sample_mask"):
            if k in batch:
                out[k] = t(batch[k], torch.bool)
        if "sample_index" in batch:
            out["sample_index"] = t(batch["sample_index"], torch.long)
        return out

    def _augmented(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """TrainConfig.augment applied to a batch on the device (identity
        when off), with the draws of the current step. Under data
        parallelism the draws are made for the global batch and each rank
        keeps its stripe's rows, so they do not depend on the world size."""
        aug = self.config.train.augment
        if not aug.enabled:
            return b
        gen = augment.step_generator(self.config.train.seed, aug.seed_offset, self.step,
                                     self.device)
        L = b["points"].shape[0]
        shapes = {k: b[k][:1].expand(L * self.world, *b[k].shape[1:])
                  for k in ("image", "points")}
        draws = {k: None if v is None else v[self.rank * L:(self.rank + 1) * L]
                 for k, v in augment.draw_augment(gen, aug, shapes).items()}
        return augment.apply_augment(b, draws, aug, pc_range=self.config.data.pc_range,
                                     ignore_index=self.config.train.ignore_index)

    def _check_mesh(self) -> None:
        """BatchNorm, the fused blocks and the loaders reduce over the active
        mesh, the trainer over its own: they must be one (at one rank, no
        other may be active)."""
        mine = spanning(self.mesh) if self.mesh is not None else None
        if mine is not spanning(active()):
            raise ValueError("Trainer: its mesh must be the active one (the last made by "
                             "parallel/mesh.py::make_mesh, not destroyed), or None with no "
                             "mesh of more than one rank active")

    def _loss_totals(self, b: Dict[str, torch.Tensor],
                     sample_weight: Optional[torch.Tensor] = None) -> Optional[LossTotals]:
        """The global batch's loss normalisers (None on one device)."""
        if self.world == 1:
            return None
        return global_loss_totals(b["segmentation"], self.class_weights,
                                  self.config.train.ignore_index, sample_weight, self.dmesh)

    def _reduce_grads(self) -> None:
        """Sum the gradients over the data axis: one flat all-reduce (per
        dtype). On a 2-D mesh, then one broadcast of the gradients and the
        student's floating-point buffers from the rank of model coordinate 0
        to its model group (the module docstring)."""
        grads = [p.grad for p in self.params.values()]
        mm = model_mesh(self.mesh) if self.mesh is not None else None
        if self.world > 1:
            for dtype in dict.fromkeys(g.dtype for g in grads):
                gs = [g for g in grads if g.dtype == dtype]
                flat = all_reduce_(torch.cat([g.reshape(-1) for g in gs]), mesh=self.dmesh)
                for g, f in zip(gs, flat.split([g.numel() for g in gs])):
                    g.copy_(f.view_as(g))
        if mm is not None:
            broadcast_(grads + [b for b in self.model.buffers() if b.is_floating_point()], 0, mm)

    def _apply_update(self, loss: torch.Tensor) -> None:
        """Backward, optional clipping, AdamW at schedule(step), EMA."""
        self.optimizer.zero_grad(set_to_none=True)
        if self._nan_guard is not None:
            self._nan_guard.backward(loss, self.params.items())
        else:
            loss.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._reduce_grads()
        tc = self.config.train
        if tc.grad_clip_norm is not None:
            clip_by_global_norm([p.grad for p in self.params.values()], tc.grad_clip_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        update_ema(tc.ema_decay, self.ema_params, self.params)

    def train_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One CE step on `batch`; returns (loss, confusion matrix) on the device."""
        b = self._augmented(self._to_device(batch))
        tc = self.config.train
        self.model.train()
        logits = self.model(b["image"], b["points"], b.get("point_valid"))
        loss = weighted_cross_entropy(logits, b["segmentation"], self.class_weights,
                                      tc.ignore_index, self._loss_totals(b))
        cm = confusion_matrix(logits.detach(), b["segmentation"], tc.metrics_num_classes,
                              tc.ignore_index)
        self._apply_update(loss)
        return loss.detach(), cm

    @torch.no_grad()
    def eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """CE and confusion matrix of the eval-mode model (the EMA weights
        when TrainConfig.ema_decay is set)."""
        b = self._to_device(batch)
        tc = self.config.train
        self.model.eval()
        args = (b["image"], b["points"], b.get("point_valid"))
        if self.ema_params is None:
            logits = self.model(*args)
        else:
            state = {k[len("model."):]: v for k, v in self.ema_params.items()
                     if k.startswith("model.")}
            state.update(self.model.named_buffers())
            logits = torch.func.functional_call(self.model, state, args)
        loss = weighted_cross_entropy(logits, b["segmentation"], self.class_weights,
                                      tc.ignore_index, self._loss_totals(b))
        cm = confusion_matrix(logits, b["segmentation"], tc.metrics_num_classes,
                              tc.ignore_index)
        return loss, cm

    # -- epoch loops ---------------------------------------------------------

    @property
    def last_loss_parts(self) -> Dict[str, float]:
        """Loss components of the most recent KD train step, as floats (under
        data parallelism this rank's shares: they sum over the ranks to the
        global batch's components)."""
        return {k: float(v) for k, v in self.last_loss_parts_raw.items()}

    def _step(self, batch, train: bool, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.train_step(batch, **kw) if train else self.eval_step(batch)

    def _chunk_extras(self, stacked: Dict[str, np.ndarray], K: int, train: bool) -> List[Dict]:
        """Per-step keyword arguments of a chunk's K steps, made from the
        stacked host chunk before its copy (the KD trainer's host-spilled
        teacher rows)."""
        return [{} for _ in range(K)]

    def _run_chunk(self, batches: List[Dict], train: bool, sums: _EpochSums) -> None:
        """len(batches) steps on views of one chunk on the device: the host
        batches stacked into [K, B, ...] and copied in one transfer."""
        stacked = {k: np.stack([np.asarray(b[k]) for b in batches]) for k in batches[0]}
        extras = self._chunk_extras(stacked, len(batches), train)
        dev = to_device_packed(stacked, self.device)
        for i, kw in enumerate(extras):
            sums.add(*self._step({k: v[i] for k, v in dev.items()}, train, **kw))

    def _run_epoch(self, loader, train: bool) -> Tuple[float, Dict]:
        tc = self.config.train
        K = tc.scan_steps
        bar = ProgressBar(len(loader) if hasattr(loader, "__len__") else None,
                          "Training" if train else "Validation", tc.progress)
        sums, pending = _EpochSums(self.dmesh), []
        # Training measures input stall (StallMeter). The share is written in
        # the finally, so an epoch that an exception cuts short (a loader
        # error, a NaN guard, a failed step) reports its own share, as the
        # JAX trainer's (trainer.py:331-346); closing the meter's iterator
        # first sets its total also when the step raised.
        meter = StallMeter(loader) if train else None
        it = iter(meter if train else loader)
        try:
            for batch in it:
                if K == 1:
                    sums.add(*self._step(batch, train))
                    bar.update(1)
                    continue
                pending.append(batch)
                if len(pending) == K:
                    self._run_chunk(pending, train, sums)
                    pending = []
                    # The running loss: one read a chunk, and none unasked.
                    bar.update(K, loss=sums.mean_loss() if bar.enabled else None)
            for batch in pending:  # the epoch's tail, one step at a time
                sums.add(*self._step(batch, train))
                bar.update(1)
        finally:
            bar.close()
            if train:
                it.close()
                self.last_host_stall_frac = meter.stall_frac
        return sums.finish(tc.metrics_num_classes)

    # -- the on-device epoch (TrainConfig.onchip_epoch / onchip_eval) ---------

    def _materialized(self, loader) -> Dict[str, torch.Tensor]:
        """The loader's whole dataset on the device (materialize_dataset with
        the Batcher's sample_transform, one copy)."""
        b = loader.batcher
        return to_device_packed(materialize_dataset(b.dataset, b.batch_size,
                                                    sample_transform=b.sample_transform),
                                self.device)

    def _onchip_rows(self, data: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        """Row-aligned extras of the contiguous on-device epoch, gathered
        once for the permuted set `data` (the KD trainer's device teacher
        cache); None when there are none."""
        return None

    def _onchip_step_kwargs(self, rows: Dict[str, torch.Tensor]) -> Dict:
        raise NotImplementedError

    def _run_epoch_onchip(self) -> Tuple[float, Dict]:
        """One training epoch over the training set resident on the device:
        each step gathers its batch (index_select by a slice of the epoch's
        permutation) or, with onchip_contiguous, reads a slice of the set
        permuted once. No host batch, no per-step copy."""
        if not hasattr(self.train_loader, "batcher"):
            raise ValueError("onchip_epoch needs a Batcher-based loader")
        if self.global_world > 1:
            raise NotImplementedError(
                "onchip_epoch is single-process: the epoch scan gathers from one "
                "HBM-resident copy of the whole dataset, which multi-host shard_batch would "
                "replicate per process. Use the host loader path under multi-host data "
                "parallelism.")
        tc = self.config.train
        batcher = self.train_loader.batcher
        B = batcher.batch_size  # the loader's, as len(train_loader) sets the schedule
        if self._onchip_data is None:
            self._onchip_data = self._materialized(self.train_loader)
        data = self._onchip_data
        n = data["sample_mask"].shape[0]
        epoch = max(getattr(batcher, "_epoch", 0), self._epoch_index)
        if getattr(batcher, "shuffle", True):
            perm = np.random.default_rng(np.random.SeedSequence(
                [tc.seed, epoch, 104729])).permutation(n)
        else:
            perm = np.arange(n)
        perm = torch.from_numpy(perm.astype(np.int64)).to(self.device)
        rows = None
        if tc.onchip_contiguous:
            data = {k: v.index_select(0, perm) for k, v in data.items()}
            rows = self._onchip_rows(data)
        bar = ProgressBar(n // B, "Training", tc.progress)
        sums = _EpochSums()
        try:
            for i in range(n // B):
                if tc.onchip_contiguous:
                    batch = {k: v[i * B:(i + 1) * B] for k, v in data.items()}
                    kw = ({} if rows is None else self._onchip_step_kwargs(
                        {k: v[i * B:(i + 1) * B] for k, v in rows.items()}))
                else:
                    idx = perm[i * B:(i + 1) * B]
                    batch, kw = {k: v.index_select(0, idx) for k, v in data.items()}, {}
                sums.add(*self.train_step(batch, **kw))
                bar.update(1)
        finally:
            bar.close()
        self.last_host_stall_frac = 0.0
        return sums.finish(tc.metrics_num_classes)

    def _run_val_onchip(self) -> Tuple[float, Dict]:
        """Validation over the val set resident on the device, in order."""
        tc = self.config.train
        B = self.val_loader.batcher.batch_size
        if self._onchip_val_data is None:
            self._onchip_val_data = self._materialized(self.val_loader)
        data = self._onchip_val_data
        sums = _EpochSums()
        for i in range(data["sample_mask"].shape[0] // B):
            sums.add(*self.eval_step({k: v[i * B:(i + 1) * B] for k, v in data.items()}))
        return sums.finish(tc.metrics_num_classes)

    def train_epoch(self) -> Tuple[float, Dict]:
        if self.config.train.onchip_epoch:
            return self._run_epoch_onchip()
        return self._run_epoch(self.train_loader, train=True)

    def validate(self) -> Tuple[float, Dict]:
        want = self.config.train.onchip_eval
        supported = hasattr(self.val_loader, "batcher") and self.global_world == 1
        if want is None:  # follow onchip_epoch where the loader allows it
            want = self.config.train.onchip_epoch and supported
        elif want and not supported:
            raise ValueError("onchip_eval=True needs a Batcher-based val loader and a single "
                             "process; set onchip_eval=None for automatic fallback to the "
                             "host path.")
        if want:
            return self._run_val_onchip()
        return self._run_epoch(self.val_loader, train=False)

    # -- checkpointing (reference: trainer.py:116-142) -------------------------

    def _payload(self) -> Dict:
        p = {"model_state": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            p["ema"] = {k: v.detach() for k, v in self.ema_params.items()}
        return p

    def _restore(self, payload: Dict) -> None:
        self.model.load_state_dict(payload["model_state"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        if self.ema_params is not None:
            src = payload.get("ema") or {k: p.detach() for k, p in self.params.items()}
            for k, e in self.ema_params.items():
                e.copy_(src[k])

    def save_checkpoint(self, epoch: int, val_miou: float, is_best: bool = False,
                        snapshot: Optional[str] = None) -> None:
        """Write latest (and best, and the snapshot); rank 0 of the mesh
        alone under data parallelism, the weights being equal on every rank."""
        if not self.is_writer:
            return
        if self.config.train.async_checkpoint:
            if self._async_ckpt is None:
                self._async_ckpt = ckpt.AsyncCheckpointer()
            self._async_ckpt.save(self.save_dir, self._payload(), epoch, val_miou, is_best,
                                  snapshot=snapshot)
        else:
            ckpt.save_checkpoint(self.save_dir, self._payload(), epoch, val_miou, is_best,
                                 snapshot=snapshot)

    def flush_checkpoints(self) -> None:
        """Wait until the async writes (if any) are on disk and stop the
        writer thread (a later save starts a new one)."""
        if self._async_ckpt is not None:
            ac, self._async_ckpt = self._async_ckpt, None
            ac.close()

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of this trainer; returns the epoch to start
        from. best_miou is the historical maximum, not latest's own value, so
        a worse model cannot overwrite best after a resume."""
        self.flush_checkpoints()
        payload = ckpt.load_checkpoint(path)
        self._restore(payload)
        start_epoch = int(payload["epoch"]) + 1
        self.history.load(truncate=start_epoch)
        prior = self.history.history.get("val_miou", [])
        self.best_miou = max([float(payload["val_miou"])] + [float(v) for v in prior])
        print(f"Resumed from {path}, starting at epoch {start_epoch}, "
              f"best mIoU {self.best_miou:.4f}")
        return start_epoch

    # -- preemption (the JAX package's trainer.py:670-678) ----------------------

    def request_preempt(self) -> None:
        """Ask the training loop to stop after the current epoch, with that
        epoch recorded and its checkpoint written and flushed; resume from
        latest.pth. Safe from any thread or a signal handler."""
        self._preempt_requested = True

    def _stop_agreed(self) -> bool:
        """Whether to stop after this epoch: under data parallelism a
        max-reduce of every rank's flag, so all ranks stop together and none
        waits in a collective that the others never reach."""
        if self.global_world == 1:
            return self._preempt_requested
        flag = torch.tensor([float(self._preempt_requested)], device=self.device)
        self._preempt_requested = bool(all_reduce_(flag, "max", mesh=self.mesh).item())
        return self._preempt_requested

    # -- main loop (reference: trainer.py:154-194) -------------------------------

    def train(self, start_epoch: int = 0, log=print) -> float:
        tc = self.config.train
        self._preempt_requested = False
        old_sigterm = None
        if tc.handle_sigterm:
            # signal.signal raises off the main thread: request_preempt() there.
            if threading.current_thread() is threading.main_thread():
                old_sigterm = signal.signal(signal.SIGTERM,
                                            lambda *_: self.request_preempt())
            else:
                warnings.warn("handle_sigterm: not on the main thread, cannot install a "
                              "SIGTERM handler; call request_preempt() instead.")
        log(f"\nStarting training from epoch {start_epoch + 1}/{tc.num_epochs}")
        try:
            for epoch in range(start_epoch, tc.num_epochs):
                self._epoch_index = epoch
                if hasattr(self.train_loader, "set_epoch"):
                    self.train_loader.set_epoch(epoch)
                t0 = time.perf_counter()
                train_loss, train_metrics = self.train_epoch()
                val_loss, val_metrics = self.validate()
                dt = time.perf_counter() - t0
                # The LR the next epoch uses (torch's post-step read, trainer.py:166-167).
                current_lr = lr_at_epoch(tc.lr, tc.eta_min, tc.num_epochs, epoch + 1)
                train_miou, val_miou = train_metrics["miou"], val_metrics["miou"]
                log(f"Epoch {epoch + 1}/{tc.num_epochs} [{dt:.1f}s, input stall "
                    f"{self.last_host_stall_frac * 100:.0f}%] "
                    f"train loss {train_loss:.4f} mIoU {train_miou:.4f} | "
                    f"val loss {val_loss:.4f} mIoU {val_miou:.4f} | "
                    f"class IoU {['%.4f' % v for v in val_metrics['class_iou']]}")
                self.history.append(train_loss, train_miou, val_loss, val_miou, current_lr)
                is_best = val_miou > self.best_miou
                if is_best:
                    self.best_miou = val_miou
                    log(f"  New best mIoU: {val_miou:.4f}")
                snap = (ckpt.snapshot_name(epoch) if tc.snapshot_every
                        and (epoch + 1) % tc.snapshot_every == 0 else None)
                self.save_checkpoint(epoch, val_miou, is_best=is_best, snapshot=snap)
                if self._stop_agreed():
                    break
        finally:
            # Restore the handler and drain pending writes, also on an error.
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)
            self.flush_checkpoints()
        if self._preempt_requested:
            log(f"Preempted — stopped after epoch {self._epoch_index + 1}; "
                f"resume from {self.save_dir}/{ckpt.LATEST}")
        else:
            log(f"Training completed! Best validation mIoU: {self.best_miou:.4f}")
        return self.best_miou
