"""Checkpoints with the reference's latest/best semantics, in torch format,
and the training-history file.

Counterpart of lmsu_tpu/training/checkpoint.py (reference trainer.py:116-152):
every epoch writes `latest.pth`, and `best.pth` whenever val mIoU improves.
A checkpoint is one `torch.save` dict: `model_state` (the model's state
dict, so `Predictor.from_torch_checkpoint` serves it), `proj` (the KD
projections, when distilling), `ema` (when TrainConfig.ema_decay is set),
`optimizer`, `step`, `epoch` and `val_miou`. The scheduler needs no state:
it is a function of `step`. Writes go to a temporary file first and are
renamed into place. JAX-package (flax msgpack) checkpoints come across as
weights through utils/weights.py.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

LATEST = "latest.pth"
BEST = "best.pth"


def save_checkpoint(save_dir: str, payload: Dict[str, Any], epoch: int, val_miou: float,
                    is_best: bool = False) -> None:
    """Write latest (+ best when is_best)."""
    os.makedirs(save_dir, exist_ok=True)
    payload = dict(payload, epoch=int(epoch), val_miou=float(val_miou))
    for name in (LATEST, BEST) if is_best else (LATEST,):
        path = os.path.join(save_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by save_checkpoint, on the CPU. It holds
    optimizer state, so it is unpickled in full: load only files this
    program wrote."""
    return torch.load(path, map_location="cpu", weights_only=False)


class HistoryWriter:
    """training_history.json with the reference schema (trainer.py:67-74,
    144-152): lists under train_loss / train_miou / val_loss / val_miou /
    lr, the file rewritten whole each epoch."""

    KEYS = ("train_loss", "train_miou", "val_loss", "val_miou", "lr")

    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "training_history.json")
        self.history = {k: [] for k in self.KEYS}

    def append(self, train_loss: float, train_miou: float, val_loss: float,
               val_miou: float, lr: float) -> None:
        for k, v in zip(self.KEYS, (train_loss, train_miou, val_loss, val_miou, lr)):
            self.history[k].append(float(v))
        with open(self.path, "w") as f:
            json.dump(self.history, f, indent=2)

    def load(self, truncate: Optional[int] = None) -> None:
        """Restore earlier epochs so a resumed run appends to them;
        truncate=N keeps the first N entries (the resumed epoch count)."""
        if os.path.exists(self.path):
            with open(self.path) as f:
                data = json.load(f)
            self.history = {k: list(data.get(k, []))[:truncate] for k in self.KEYS}
