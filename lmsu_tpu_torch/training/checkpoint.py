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

TrainConfig.snapshot_every also writes an immutable `epoch_###.pth` (the
JAX package's epoch_###.ckpt) from the same payload; it loads as a
--teacher-checkpoint. TrainConfig.async_checkpoint writes through
`AsyncCheckpointer` (the JAX package's, checkpoint.py:55-139): the state is
copied on the device and a worker thread copies it to the host and writes
it.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, Dict, Optional

import torch

LATEST = "latest.pth"
BEST = "best.pth"


def snapshot_name(epoch: int) -> str:
    """The snapshot file of (0-based) `epoch`: epoch_###.pth, 1-based."""
    return f"epoch_{epoch + 1:03d}.pth"


def save_checkpoint(save_dir: str, payload: Dict[str, Any], epoch: int, val_miou: float,
                    is_best: bool = False, snapshot: Optional[str] = None) -> None:
    """Write latest (+ best when is_best, + the file `snapshot` when named)."""
    os.makedirs(save_dir, exist_ok=True)
    payload = dict(payload, epoch=int(epoch), val_miou=float(val_miou))
    names = (LATEST,) + ((BEST,) if is_best else ()) + ((snapshot,) if snapshot else ())
    for name in names:
        path = os.path.join(save_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def map_tensors(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """`tree` (dicts, lists, tuples) with fn applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


class AsyncCheckpointer:
    """Checkpoint writes that overlap training (the JAX package's
    AsyncCheckpointer, checkpoint.py:55-139).

    `save()` clones every tensor of the payload on its own device, on the
    current stream (the next steps update the state in place; the clones
    live until the write is done), records a CUDA event after the clones,
    and queues them. One worker thread waits for that event on a stream of
    its own (not a synchronize of the main thread), copies the clones to the
    host, and writes latest / best / the snapshot through save_checkpoint
    (torch.save to a temporary file, then an atomic rename). Writes are
    FIFO, so latest.pth ends at the newest epoch. The queue holds two
    saves: each holds a copy of the state on the device.

    A worker's exception is raised again at the next save(), wait() or
    close(). Trainer.flush_checkpoints waits and closes at the end of
    train() and before any resume load."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="lmsu-torch-ckpt-writer")
        self._thread.start()

    def save(self, save_dir: str, payload: Dict[str, Any], epoch: int, val_miou: float,
             is_best: bool = False, snapshot: Optional[str] = None) -> None:
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        devices = set()

        def clone(t):
            if t.is_cuda:
                devices.add(t.device)
            return t.detach().clone()
        snap = map_tensors(payload, clone)
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append((dev, ev))
        self._q.put((save_dir, snap, events, int(epoch), float(val_miou), bool(is_best),
                     snapshot))

    def wait(self) -> None:
        """Block until every queued checkpoint is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain the queue, stop the worker, raise any pending error.
        Idempotent; a closed checkpointer refuses save()."""
        if not self._closed:
            self._closed = True
            if self._thread.is_alive():
                self._q.put(None)
                self._thread.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                save_dir, snap, events, epoch, val_miou, is_best, snapshot = item
                for dev, ev in events:
                    side = torch.cuda.Stream(dev)
                    side.wait_event(ev)
                    with torch.cuda.stream(side):
                        snap = map_tensors(snap, lambda t: t.cpu() if t.device == dev else t)
                save_checkpoint(save_dir, snap, epoch, val_miou, is_best, snapshot=snapshot)
            except BaseException as e:  # raised again at the next save()/wait()
                self._error = e
            finally:
                self._q.task_done()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by save_checkpoint, on the CPU. It holds
    optimizer state, so it is unpickled in full: load only files this
    program wrote."""
    return torch.load(path, map_location="cpu", weights_only=False)


class HistoryWriter:
    """training_history.json with the reference schema (trainer.py:67-74,
    144-152): lists under train_loss / train_miou / val_loss / val_miou /
    lr, the file rewritten whole each epoch. With write=False (a data-parallel
    rank other than 0) it keeps the history in memory and writes nothing."""

    KEYS = ("train_loss", "train_miou", "val_loss", "val_miou", "lr")

    def __init__(self, save_dir: str, write: bool = True):
        self.write = write
        if write:
            os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "training_history.json")
        self.history = {k: [] for k in self.KEYS}

    def append(self, train_loss: float, train_miou: float, val_loss: float,
               val_miou: float, lr: float) -> None:
        for k, v in zip(self.KEYS, (train_loss, train_miou, val_loss, val_miou, lr)):
            self.history[k].append(float(v))
        if not self.write:
            return
        with open(self.path, "w") as f:
            json.dump(self.history, f, indent=2)

    def load(self, truncate: Optional[int] = None) -> None:
        """Restore earlier epochs so a resumed run appends to them;
        truncate=N keeps the first N entries (the resumed epoch count)."""
        if os.path.exists(self.path):
            with open(self.path) as f:
                data = json.load(f)
            self.history = {k: list(data.get(k, []))[:truncate] for k in self.KEYS}
