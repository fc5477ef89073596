"""Teacher->student knowledge distillation trainer.

Counterpart of lmsu_tpu/training/distill.py (DistillationTrainer):

  loss = CE(student, labels)
       + alpha * T^2 * KL(teacher || student)              (logit distillation)
       + beta  * mean_t MSE(student_t, teacher_t . P_t)    (feature matching)

  * the teacher is a width-multiplied variant of the student
    (config.teacher_config), loaded from a state dict or a checkpoint, or
    drawn from seed + 1; it runs in eval mode under torch.no_grad, so its
    outputs carry no gradient (the JAX package's stop_gradient);
  * an ensemble of K such teachers (KDConfig.teacher_checkpoints, or
    ensemble_size random members drawn from seed + 1 + i, or a list of
    state dicts) presents as one teacher with member-averaged logits and
    taps (EnsembleTeacher);
  * the taps come from the model's intermediates (camera_feat, lidar_feat,
    pre_fusion, post_fusion); the port's taps are NCHW tensors, and the
    losses take them channels-last, as the JAX package's do;
  * per-tap projections P_t [Ct, Cs], drawn from seed + 2 as
    normal / sqrt(Ct), train jointly with the student (AdamW over both);
  * KDConfig.use_pallas routes the feature matching through the
    hand-written kernel (ops/kd_loss.py), else ops/losses.py;
  * `sample_mask` weights out the padding samples of a final partial batch;
  * KDConfig.cache_teacher: one teacher pass over the training loader, on
    clean batches, at the first training epoch, stores the teacher's logits
    and taps by sample index; each step then gathers its rows instead of
    running the teacher. The cache stays on the device while it fits
    KDConfig.cache_hbm_limit_bytes, else it spills to host memory and each
    step's rows go through a pinned staging buffer. With augmentation this
    is noisy-student KD: the targets are from clean inputs and only the
    student sees the augmented batch (the in-loop teacher sees it too).

`train_step(batch, teacher_out=...)` also takes the teacher's outputs
computed beforehand (`teacher_forward`): the bench-style cached step, where
they are computed once for a fixed batch (bench.py:233-244).

The trainer's loops (training/trainer.py) run all three KD variants, as the
JAX package's (distill.py:411-454, 557-686): with scan_steps the
host-spilled cache gathers a chunk's rows on the host before its copy;
the on-device epoch takes the in-loop teacher or the device cache (with
onchip_contiguous the cache is permuted with the set, once an epoch, and
each step gets its rows pre-gathered); the spilled cache cannot ride it
(NotImplementedError). Refused by name: teacher partitioning over devices
("sp", "fsdp").
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lmsu_tpu_torch.config import ExperimentConfig, ModelConfig, teacher_config
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.factory import check_kernel_shapes
from lmsu_tpu_torch.ops.kd_loss import check_kd_feature_mse, kd_total_loss_fused
from lmsu_tpu_torch.ops.losses import kd_total_loss
from lmsu_tpu_torch.ops.metrics import confusion_matrix
from lmsu_tpu_torch.training.trainer import Trainer


def tap_channels(config: ModelConfig) -> Dict[str, int]:
    """Channel widths of each KD tap for a model config (the JAX package's
    distill.py::_tap_channels): concat's pre_fusion is the camera and LiDAR
    widths side by side and its post_fusion fusion_out_channels; the other
    fusions keep the camera width for both."""
    cam = config.camera_fpn_channels if config.camera.return_multiscale \
        else config.camera.channels[2]
    lidar = config.lidar.feature_dim
    if config.fusion_type == "concat":
        pre, post = cam + lidar, config.fusion_out_channels
    else:
        pre = post = cam
    return {"camera_feat": cam, "lidar_feat": lidar, "pre_fusion": pre,
            "post_fusion": post, "logits": config.num_classes}


def channels_last(taps: Mapping[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """NCHW taps -> [B, H, W, C] views (no copy for channels-last memory)."""
    return {k: taps[k].permute(0, 2, 3, 1) for k in names}


def check_kd_config(kd) -> None:
    if kd.teacher_partition not in ("tp", "sp", "fsdp"):
        raise ValueError(f"unknown KDConfig.teacher_partition {kd.teacher_partition!r}")
    if kd.teacher_partition in ("sp", "fsdp"):
        raise NotImplementedError(f"not ported yet: KDConfig.teacher_partition="
                                  f"{kd.teacher_partition!r} (teacher partitioning)")
    if kd.cache_dtype not in ("auto", "bfloat16"):
        raise ValueError(f"KDConfig.cache_dtype must be 'auto' or 'bfloat16', "
                         f"got {kd.cache_dtype!r}")
    if kd.ensemble_size < 1:
        raise ValueError(f"KDConfig.ensemble_size must be >= 1, got {kd.ensemble_size}")


def _load_teacher_state(path: str) -> Dict[str, torch.Tensor]:
    """A teacher's weights from a .pth this trainer wrote (its model_state)
    or a bare state dict. Unpickled in full: load only files this program
    wrote."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return raw.get("model_state", raw)


class EnsembleTeacher(torch.nn.Module):
    """K same-config teachers presented as one (the JAX package's
    EnsembleTeacher): the members run one after another and their logits
    and every tap are averaged in member order, torch.stack(...).mean(0),
    so every KD path (in-loop, cached, host-spilled) works unchanged.
    Averaging logits, not probabilities, keeps the target well defined
    under any temperature. With K = 1 the member's output comes back
    unchanged, bit for bit the single teacher's. (The JAX package vmaps
    over stacked weights; the port's kernels are launched per call.)"""

    def __init__(self, members: Sequence[torch.nn.Module]):
        super().__init__()
        if not members:
            raise ValueError("an ensemble needs at least one member")
        self.members = torch.nn.ModuleList(members)

    def forward(self, images, points, point_valid=None, return_intermediates=False):
        outs = [m(images, points, point_valid, return_intermediates=return_intermediates)
                for m in self.members]
        if len(outs) == 1:
            return outs[0]

        def mean(xs):
            return torch.stack(xs).mean(0)
        if not return_intermediates:
            return mean(outs)
        return (mean([o[0] for o in outs]),
                {k: mean([o[1][k] for o in outs]) for k in outs[0][1]})


class DistillationTrainer(Trainer):
    """Trainer whose train step distills from a frozen teacher (in the step,
    or from the dataset-wide cache).

    `teacher_state_dict` is one state dict, or a list of them for an
    ensemble (its length is then the member count). The default
    teacher_partition "tp" means, on one device as in the JAX package's 1-D
    mesh, a replicated (whole) teacher."""

    def __init__(self, config: ExperimentConfig, train_loader, val_loader, *,
                 teacher_state_dict: Union[None, Mapping[str, torch.Tensor],
                                           Sequence[Mapping[str, torch.Tensor]]] = None,
                 teacher_model_config: Optional[ModelConfig] = None, device="cuda"):
        self.kd = config.train.kd
        check_kd_config(self.kd)
        self.teacher_config = teacher_model_config or teacher_config(
            config.model, self.kd.teacher_width_mult)
        self.num_teachers = (len(self.kd.teacher_checkpoints) if self.kd.teacher_checkpoints
                             else self.kd.ensemble_size)
        if isinstance(teacher_state_dict, (list, tuple)):
            self.num_teachers = len(teacher_state_dict)
        elif teacher_state_dict is not None and self.num_teachers > 1:
            raise ValueError(
                f"KD config asks for {self.num_teachers} ensemble members but "
                "teacher_state_dict is a single state dict; pass a list of member "
                "state dicts")
        self._teacher_sd = teacher_state_dict
        self.loss_impl = kd_total_loss_fused if self.kd.use_pallas else kd_total_loss
        self.teacher_cache: Optional[Dict[str, torch.Tensor]] = None       # on the device
        self.teacher_cache_host: Optional[Dict[str, torch.Tensor]] = None  # spilled
        super().__init__(config, train_loader, val_loader, device=device)

    def _teacher_states(self) -> Optional[List[Mapping[str, torch.Tensor]]]:
        """The members' weights, in member order; None for random members."""
        sd, kd = self._teacher_sd, self.kd
        if isinstance(sd, (list, tuple)):
            return list(sd)
        if sd is not None:
            return [sd]
        if kd.teacher_checkpoints:
            return [_load_teacher_state(c) for c in kd.teacher_checkpoints]
        if self.num_teachers == 1 and kd.teacher_checkpoint:
            return [_load_teacher_state(kd.teacher_checkpoint)]
        return None

    def _init_extra_params(self) -> Dict[str, torch.nn.Parameter]:
        seed = self.config.train.seed
        # Random members are drawn from seed + 1 + i: member 0 is the single
        # teacher's draw.
        members = [create_model(self.teacher_config, seed=seed + 1 + i)
                   for i in range(self.num_teachers)]
        self.teacher = members[0] if self.num_teachers == 1 else EnsembleTeacher(members)
        for m, sd in zip(members, self._teacher_states() or ()):
            m.load_state_dict(sd, strict=True)
        self.teacher.to(self.device).eval().requires_grad_(False)
        check_kernel_shapes(self.teacher, self.device, train=False)
        self._teacher_sd = None
        s_ch, t_ch = tap_channels(self.config.model), tap_channels(self.teacher_config)
        if self.kd.use_pallas and self.device.type == "cuda":
            for tap in self.kd.feature_taps:
                check_kd_feature_mse(tap, s_ch[tap], t_ch[tap], self.kd.teacher_width_mult)
        gen = torch.Generator().manual_seed(seed + 2)
        self.proj = torch.nn.ParameterDict()
        for tap in self.kd.feature_taps:
            ct, cs = t_ch[tap], s_ch[tap]
            self.proj[tap] = torch.nn.Parameter(
                (torch.randn(ct, cs, generator=gen) / math.sqrt(ct)).to(self.device))
        return {f"proj.{tap}": p for tap, p in self.proj.items()}

    @torch.no_grad()
    def teacher_forward(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The frozen teacher's logits and feature taps for `batch` (a batch
        on the device, as `_to_device` makes it, or a host batch)."""
        b = batch if isinstance(batch.get("image"), torch.Tensor) \
            and batch["image"].device == self.device else self._to_device(batch)
        logits, taps = self.teacher(b["image"], b["points"], b.get("point_valid"),
                                    return_intermediates=True)
        return logits, {tap: taps[tap] for tap in self.kd.feature_taps}

    # -- the dataset-wide teacher cache (KDConfig.cache_teacher) --------------

    def _cache_dtype(self) -> torch.dtype:
        """KDConfig.cache_dtype: "auto" follows the compute dtype."""
        if self.kd.cache_dtype == "bfloat16":
            return torch.bfloat16
        return torch.bfloat16 if self.config.model.compute_dtype == torch.bfloat16 \
            else torch.float32

    @torch.no_grad()
    def build_teacher_cache(self) -> None:
        """One teacher pass over the training loader, on clean batches: the
        logits and feature taps of every sample, in rows keyed by
        sample_index. On the device while the cache fits
        KDConfig.cache_hbm_limit_bytes, else in (pageable) host memory."""
        if not hasattr(self.train_loader, "batcher"):
            raise ValueError("cache_teacher requires a Batcher-based loader")
        n = len(self.train_loader.batcher.dataset)
        dt = self._cache_dtype()
        cache: Optional[Dict[str, torch.Tensor]] = None
        on_device = True
        filled = torch.zeros(n, dtype=torch.bool)
        for batch in self.train_loader:
            b = self._to_device(batch)
            logits, taps = self.teacher_forward(b)
            rows = {"logits": logits, **taps}
            if cache is None:
                per_sample = sum(v[0].numel() for v in rows.values()) * dt.itemsize
                total = per_sample * n
                on_device = total <= self.kd.cache_hbm_limit_bytes
                where = self.device if on_device else torch.device("cpu")
                if on_device:
                    print(f"teacher cache: {total / 1e9:.2f} GB on the device "
                          f"({n} samples x {per_sample / 1e6:.2f} MB)")
                else:
                    print(f"teacher cache: {total / 1e9:.2f} GB > HBM limit "
                          f"{self.kd.cache_hbm_limit_bytes / 1e9:.2f} GB — "
                          f"spilling to host RAM ({n} samples x "
                          f"{per_sample / 1e6:.2f} MB)")
                cache = {k: torch.zeros((n,) + tuple(v.shape[1:]), dtype=dt, device=where)
                         for k, v in rows.items()}
            # The padding rows of a final partial batch repeat a real sample:
            # only the real rows are written.
            real = b["sample_mask"] if "sample_mask" in b else \
                torch.ones_like(b["sample_index"], dtype=torch.bool)
            idx = b["sample_index"][real]
            for k, v in rows.items():
                dst = cache[k]
                dst.index_copy_(0, idx.to(dst.device), v[real].to(dst.device, dt))
            filled[idx.cpu()] = True
        # A loader that skips samples (drop_last) would leave all-zero rows
        # that silently corrupt the targets.
        if not bool(filled.all()):
            raise AssertionError("teacher cache fill missed samples")
        if on_device:
            self.teacher_cache = cache
        else:
            self.teacher_cache_host = cache

    def _gather_host(self, idx) -> Dict[str, torch.Tensor]:
        """Rows `idx` (host sample indices) of the spilled cache on the
        device: a host gather into a pinned staging buffer and a
        non_blocking copy, per cached tensor."""
        idx = (idx.cpu() if isinstance(idx, torch.Tensor)
               else torch.from_numpy(np.asarray(idx))).long().reshape(-1)
        pin = self.device.type == "cuda"
        rows = {}
        for k, v in self.teacher_cache_host.items():
            staged = torch.empty((len(idx),) + tuple(v.shape[1:]), dtype=v.dtype,
                                 pin_memory=pin)
            torch.index_select(v, 0, idx, out=staged)
            rows[k] = staged.to(self.device, non_blocking=pin)
        return rows

    def _teacher_out(self, rows) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return rows["logits"], {tap: rows[tap] for tap in self.kd.feature_taps}

    def gather_teacher(self, batch, b) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """This batch's (logits, taps) from the cache, on the device: an
        index_select on the device cache; from the host spill, a host gather
        into a pinned staging buffer and a non_blocking copy. `batch` is the
        host batch, `b` its `_to_device` copy."""
        if self.teacher_cache is not None:
            return self._teacher_out({k: v.index_select(0, b["sample_index"])
                                      for k, v in self.teacher_cache.items()})
        return self._teacher_out(self._gather_host(batch["sample_index"]))

    # -- the loops' hooks (training/trainer.py) --------------------------------

    def _guarded_modules(self) -> Dict[str, torch.nn.Module]:
        return {"model": self.model, "teacher": self.teacher}

    def _chunk_extras(self, stacked, K: int, train: bool) -> List[Dict]:
        """With the spilled cache, the chunk's teacher rows: gathered on the
        host for all K x B samples before the copy, one copy per cached
        tensor, each step given its slice."""
        extras = super()._chunk_extras(stacked, K, train)
        if not train or self.teacher_cache_host is None:
            return extras
        B = stacked["sample_index"].shape[1]
        rows = {k: v.view(K, B, *v.shape[1:])
                for k, v in self._gather_host(stacked["sample_index"]).items()}
        return [{"teacher_out": self._teacher_out({k: v[i] for k, v in rows.items()})}
                for i in range(K)]

    def _run_epoch_onchip(self) -> Tuple[float, Dict]:
        if self.teacher_cache_host is not None:
            raise NotImplementedError(
                "onchip_epoch with cache_teacher needs the cache HBM-resident (raise "
                "KDConfig.cache_hbm_limit_bytes); the host-spilled cache is gathered per "
                "batch and can only ride the host loader path.")
        return super()._run_epoch_onchip()

    def _onchip_rows(self, data):
        """The device cache permuted with the set: one whole-cache gather by
        the permuted sample_index."""
        if self.teacher_cache is None:
            return None
        return {k: v.index_select(0, data["sample_index"]) for k, v in self.teacher_cache.items()}

    def _onchip_step_kwargs(self, rows) -> Dict:
        return {"teacher_out": self._teacher_out(rows)}

    def train_epoch(self) -> Tuple[float, Dict]:
        # The cache is built at the first training epoch (after a resume
        # too: it is not checkpointed), as in the JAX package.
        if self.kd.cache_teacher and self.teacher_cache is None \
                and self.teacher_cache_host is None:
            self.build_teacher_cache()
        return super().train_epoch()

    def train_step(self, batch, teacher_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One KD step. The teacher's outputs are `teacher_out` =
        teacher_forward(batch) computed beforehand when given, else this
        batch's rows of the teacher cache once it is built (both from clean
        inputs), else the teacher runs in the step on the augmented batch."""
        b = self._to_device(batch)
        tc, kd = self.config.train, self.kd
        if teacher_out is None and (self.teacher_cache is not None
                                    or self.teacher_cache_host is not None):
            teacher_out = self.gather_teacher(batch, b)
        b = self._augmented(b)
        t_logits, t_taps = teacher_out if teacher_out is not None else self.teacher_forward(b)
        self.model.train()
        s_logits, s_taps = self.model(b["image"], b["points"], b.get("point_valid"),
                                      return_intermediates=True)
        loss, parts = self.loss_impl(
            s_logits, t_logits, channels_last(s_taps, kd.feature_taps),
            channels_last(t_taps, kd.feature_taps), b["segmentation"],
            class_weights=self.class_weights, ignore_index=tc.ignore_index,
            temperature=kd.temperature, alpha_kl=kd.alpha_kl, beta_feature=kd.beta_feature,
            feature_taps=kd.feature_taps, projections=dict(self.proj.items()),
            sample_weight=b.get("sample_mask"))
        cm = confusion_matrix(s_logits.detach(), b["segmentation"], tc.metrics_num_classes,
                              tc.ignore_index)
        self._apply_update(loss)
        self.last_loss_parts_raw = {k: v.detach() for k, v in parts.items()}
        return loss.detach(), cm

    def _payload(self) -> Dict:
        p = super()._payload()
        p["proj"] = {k: v.detach().cpu() for k, v in self.proj.items()}
        return p

    def _restore(self, payload: Dict) -> None:
        with torch.no_grad():
            for k, v in payload["proj"].items():
                self.proj[k].copy_(v)
        super()._restore(payload)
