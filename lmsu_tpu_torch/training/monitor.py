"""Run monitoring for the trainers: TrainConfig.debug_nans and
TrainConfig.progress.

`NanGuard` stands in for the JAX package's jax_debug_nans + jax_debug_infs
(trainer.py:140-141): the first NaN or Inf that a module's forward or a
backward Function produces raises FloatingPointError naming it. Forward
hooks on every submodule check its floating-point outputs (a module whose
forward calls convolutions functionally, as `layers.apply_seq` does, is
seen at the next module it calls, a BatchNorm); the backward runs under
autograd's anomaly mode, whose NaN check names the Function, and an Inf
that reaches a gradient is named by its parameter. Each check reads back
from the device: a debug option.

`ProgressBar` is a small bar of the port's own on stderr (no tqdm): a count
per step, and a running loss where the caller passes one.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Mapping, Optional

import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, Mapping):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def _finite(t: torch.Tensor) -> bool:
    return not t.is_floating_point() or bool(torch.isfinite(t).all())


class NanGuard:
    """Raises FloatingPointError at the first non-finite value a module's
    forward or a backward Function produces (see the module docstring).
    `modules` maps a prefix (e.g. "student") to a module; `remove()` takes
    the hooks off."""

    def __init__(self, modules: Mapping[str, torch.nn.Module]):
        self._handles = []
        for prefix, root in modules.items():
            for name, mod in root.named_modules():
                label = f"{prefix}.{name}" if name else prefix
                self._handles.append(mod.register_forward_hook(self._hook(label)))

    @staticmethod
    def _hook(label):
        def check(mod, inputs, out):
            for t in _tensors(out):
                if not _finite(t):
                    raise FloatingPointError(
                        f"debug_nans: the forward of {label} ({type(mod).__name__}) "
                        f"produced a NaN or Inf")
        return check

    @staticmethod
    def backward(loss: torch.Tensor, named_params: Iterable) -> None:
        """loss.backward() under anomaly mode; a NaN from a backward Function
        or an Inf in a parameter's gradient raises FloatingPointError."""
        if not _finite(loss):
            raise FloatingPointError("debug_nans: the loss is NaN or Inf")
        with torch.autograd.detect_anomaly(check_nan=True):
            try:
                loss.backward()
            except RuntimeError as e:
                if "nan values" not in str(e):
                    raise
                raise FloatingPointError(f"debug_nans: {e}") from e
        for name, p in named_params:
            if p.grad is not None and not _finite(p.grad):
                raise FloatingPointError(f"debug_nans: the gradient of {name} is NaN or Inf")

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class ProgressBar:
    """`desc: i/total [loss x] [rate it/s]` rewritten in place on stderr
    (the reference's per-step tqdm loops, trainer.py:81,100); writes
    nothing unless `enabled`."""

    def __init__(self, total: Optional[int], desc: str, enabled: bool = True, stream=None):
        self.total, self.desc, self.enabled = total, desc, enabled
        self.stream = stream if stream is not None else sys.stderr
        self.n, self.loss = 0, None
        self.t0 = time.perf_counter()

    def update(self, n: int = 1, loss: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.n += n
        if loss is not None:
            self.loss = loss
        total = f"/{self.total}" if self.total is not None else ""
        rate = self.n / max(time.perf_counter() - self.t0, 1e-9)
        loss_s = f" loss {self.loss:.4f}" if self.loss is not None else ""
        self.stream.write(f"\r{self.desc}: {self.n}{total}{loss_s} [{rate:.2f} it/s]")
        self.stream.flush()

    def close(self) -> None:
        if self.enabled:
            self.stream.write("\n")
            self.stream.flush()
