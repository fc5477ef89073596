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

Not ported yet, and refused by name: scan_steps > 1, onchip_epoch,
onchip_eval=True, augmentation, data/model parallelism, SIGTERM handling,
async and snapshot checkpoints, debug_nans, progress bars.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.config import ExperimentConfig
from lmsu_tpu_torch.inference import resolve_device
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.factory import check_kernel_shapes
from lmsu_tpu_torch.ops.losses import weighted_cross_entropy
from lmsu_tpu_torch.ops.metrics import confusion_matrix, iou_from_confusion
from lmsu_tpu_torch.training import checkpoint as ckpt
from lmsu_tpu_torch.training.schedule import cosine_epoch_schedule, lr_at_epoch


def check_train_config(config: ExperimentConfig) -> None:
    """Raise NotImplementedError naming each training option the port does
    not have yet."""
    tc = config.train
    refused = {
        "TrainConfig.scan_steps > 1": tc.scan_steps != 1,
        "TrainConfig.onchip_epoch": tc.onchip_epoch,
        "TrainConfig.onchip_eval=True": tc.onchip_eval is True,
        "TrainConfig.onchip_contiguous": tc.onchip_contiguous,
        "TrainConfig.augment (augmentation)": tc.augment.enabled,
        "TrainConfig.handle_sigterm": tc.handle_sigterm,
        "TrainConfig.async_checkpoint": tc.async_checkpoint,
        "TrainConfig.snapshot_every": tc.snapshot_every is not None,
        "TrainConfig.debug_nans": tc.debug_nans,
        "TrainConfig.progress": tc.progress,
        "MeshConfig (data/model parallelism)": (config.mesh.model_parallel != 1
                                                or config.mesh.num_devices not in (None, 1)),
    }
    bad = [name for name, on in refused.items() if on]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


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
    `device="cpu"` is asked for."""

    def __init__(self, config: ExperimentConfig, train_loader, val_loader, *,
                 device="cuda", model=None):
        check_train_config(config)
        self.device = resolve_device(device)
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
        self.optimizer, self.schedule = make_optimizer(tc, self.params.values(),
                                                       self.steps_per_epoch)
        self.step = 0
        self.ema_params = ({k: p.detach().clone() for k, p in self.params.items()}
                           if tc.ema_decay is not None else None)
        self.best_miou = 0.0
        self.last_host_stall_frac = 0.0
        self.last_loss_parts_raw: Dict[str, torch.Tensor] = {}
        self.save_dir = tc.save_dir
        self.history = ckpt.HistoryWriter(self.save_dir)

    def _init_extra_params(self) -> Dict[str, torch.nn.Parameter]:
        """Trainable parameters beside the model's (the KD projections)."""
        return {}

    # -- steps ---------------------------------------------------------------

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
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
        return out

    def _apply_update(self, loss: torch.Tensor) -> None:
        """Backward, optional clipping, AdamW at schedule(step), EMA."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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
        b = self._to_device(batch)
        tc = self.config.train
        self.model.train()
        logits = self.model(b["image"], b["points"], b.get("point_valid"))
        loss = weighted_cross_entropy(logits, b["segmentation"], self.class_weights,
                                      tc.ignore_index)
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
                                      tc.ignore_index)
        cm = confusion_matrix(logits, b["segmentation"], tc.metrics_num_classes,
                              tc.ignore_index)
        return loss, cm

    # -- epoch loops ---------------------------------------------------------

    @property
    def last_loss_parts(self) -> Dict[str, float]:
        """Loss components of the most recent KD train step, as floats."""
        return {k: float(v) for k, v in self.last_loss_parts_raw.items()}

    def _run_epoch(self, loader, train: bool) -> Tuple[float, Dict]:
        total, cm, n = None, None, 0
        waited, t0 = 0.0, time.perf_counter()
        it = iter(loader)
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            waited += time.perf_counter() - tw
            if batch is None:
                break
            loss, c = self.train_step(batch) if train else self.eval_step(batch)
            total = loss.float() if total is None else total + loss.float()
            cm = c if cm is None else cm + c
            n += 1
        if train:
            self.last_host_stall_frac = waited / max(time.perf_counter() - t0, 1e-9)
        k = self.config.train.metrics_num_classes
        mean_loss = float(total) / max(n, 1) if n else 0.0
        cm_host = cm.cpu().numpy() if cm is not None else np.zeros((k, k), np.int64)
        return mean_loss, iou_from_confusion(cm_host)

    def train_epoch(self) -> Tuple[float, Dict]:
        return self._run_epoch(self.train_loader, train=True)

    def validate(self) -> Tuple[float, Dict]:
        return self._run_epoch(self.val_loader, train=False)

    # -- checkpointing (reference: trainer.py:116-142) -------------------------

    def _payload(self) -> Dict:
        p = {"model_state": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            p["ema"] = {k: v.detach().cpu() for k, v in self.ema_params.items()}
        return p

    def _restore(self, payload: Dict) -> None:
        self.model.load_state_dict(payload["model_state"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        if self.ema_params is not None:
            src = payload.get("ema") or {k: p.detach() for k, p in self.params.items()}
            for k, e in self.ema_params.items():
                e.copy_(src[k])

    def save_checkpoint(self, epoch: int, val_miou: float, is_best: bool = False) -> None:
        ckpt.save_checkpoint(self.save_dir, self._payload(), epoch, val_miou, is_best)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of this trainer; returns the epoch to start
        from. best_miou is the historical maximum, not latest's own value, so
        a worse model cannot overwrite best after a resume."""
        payload = ckpt.load_checkpoint(path)
        self._restore(payload)
        start_epoch = int(payload["epoch"]) + 1
        self.history.load(truncate=start_epoch)
        prior = self.history.history.get("val_miou", [])
        self.best_miou = max([float(payload["val_miou"])] + [float(v) for v in prior])
        print(f"Resumed from {path}, starting at epoch {start_epoch}, "
              f"best mIoU {self.best_miou:.4f}")
        return start_epoch

    # -- main loop (reference: trainer.py:154-194) -------------------------------

    def train(self, start_epoch: int = 0, log=print) -> float:
        tc = self.config.train
        log(f"\nStarting training from epoch {start_epoch + 1}/{tc.num_epochs}")
        for epoch in range(start_epoch, tc.num_epochs):
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
            self.save_checkpoint(epoch, val_miou, is_best=is_best)
        log(f"Training completed! Best validation mIoU: {self.best_miou:.4f}")
        return self.best_miou
