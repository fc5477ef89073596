"""Training: the epoch-loop Trainer, the KD DistillationTrainer, checkpoints
and the LR schedule."""

from lmsu_tpu_torch.training.distill import DistillationTrainer
from lmsu_tpu_torch.training.trainer import Trainer, make_optimizer, update_ema

__all__ = ["Trainer", "DistillationTrainer", "make_optimizer", "update_ema"]
