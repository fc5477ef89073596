"""Teacher->student knowledge distillation trainer.

Counterpart of lmsu_tpu/training/distill.py (DistillationTrainer, one
in-loop teacher):

  loss = CE(student, labels)
       + alpha * T^2 * KL(teacher || student)              (logit distillation)
       + beta  * mean_t MSE(student_t, teacher_t . P_t)    (feature matching)

  * the teacher is a width-multiplied variant of the student
    (config.teacher_config), loaded from a state dict or a checkpoint, or
    drawn from seed + 1; it runs in eval mode under torch.no_grad, so its
    outputs carry no gradient (the JAX package's stop_gradient);
  * the taps come from the model's intermediates (camera_feat, lidar_feat,
    pre_fusion, post_fusion); the port's taps are NCHW tensors, and the
    losses take them channels-last, as the JAX package's do;
  * per-tap projections P_t [Ct, Cs], drawn from seed + 2 as
    normal / sqrt(Ct), train jointly with the student (AdamW over both);
  * KDConfig.use_pallas routes the feature matching through the
    hand-written kernel (ops/kd_loss.py), else ops/losses.py;
  * `sample_mask` weights out the padding samples of a final partial batch.

`train_step(batch, teacher_out=...)` takes the teacher's outputs computed
beforehand (`teacher_forward`): the bench-style cached step, where they are
computed once for a fixed batch (bench.py:233-244). Refused by name:
ensembles, the trainer's dataset-wide teacher cache (KDConfig.cache_teacher,
with its host spill) and teacher partitioning over devices.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

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
    refused = {
        "KDConfig.teacher_checkpoints / ensemble_size > 1 (teacher ensembles)":
            bool(kd.teacher_checkpoints) or kd.ensemble_size != 1,
        "KDConfig.cache_teacher (the trainer's teacher cache and host spill)":
            kd.cache_teacher,
        f"KDConfig.teacher_partition={kd.teacher_partition!r} (teacher partitioning)":
            kd.teacher_partition in ("sp", "fsdp"),
    }
    bad = [name for name, on in refused.items() if on]
    if kd.teacher_partition not in ("tp", "sp", "fsdp"):
        raise ValueError(f"unknown KDConfig.teacher_partition {kd.teacher_partition!r}")
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class DistillationTrainer(Trainer):
    """Trainer whose train step distills from a frozen in-loop teacher.

    The default teacher_partition "tp" means, on one device as in the JAX
    package's 1-D mesh, a replicated (whole) teacher."""

    def __init__(self, config: ExperimentConfig, train_loader, val_loader, *,
                 teacher_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 teacher_model_config: Optional[ModelConfig] = None, device="cuda"):
        self.kd = config.train.kd
        check_kd_config(self.kd)
        self.teacher_config = teacher_model_config or teacher_config(
            config.model, self.kd.teacher_width_mult)
        self._teacher_sd = teacher_state_dict
        self.loss_impl = kd_total_loss_fused if self.kd.use_pallas else kd_total_loss
        super().__init__(config, train_loader, val_loader, device=device)

    def _init_extra_params(self) -> Dict[str, torch.nn.Parameter]:
        seed = self.config.train.seed
        self.teacher = create_model(self.teacher_config, seed=seed + 1)
        sd = self._teacher_sd
        if sd is None and self.kd.teacher_checkpoint:
            raw = torch.load(self.kd.teacher_checkpoint, map_location="cpu",
                             weights_only=False)
            sd = raw.get("model_state", raw)
        if sd is not None:
            self.teacher.load_state_dict(sd, strict=True)
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

    def train_step(self, batch, teacher_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One KD step; `teacher_out` = teacher_forward(batch) computed
        beforehand (cached teacher), else the teacher runs in the step."""
        b = self._to_device(batch)
        tc, kd = self.config.train, self.kd
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
