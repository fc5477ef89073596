"""Run control of the port's trainers (TrainConfig.async_checkpoint,
snapshot_every, handle_sigterm, debug_nans, progress; the JAX package's
checkpoint.py:55-139 and trainer.py:625-748), on the CPU with the small
pillar model of tests/test_torch_epoch_loops.py, mirroring the JAX
package's tests/test_trainer.py:546-680: a resume from an async run, async
files equal to synchronous ones, a snapshot that survives its source being
overwritten, a sticky worker error, snapshots every N epochs that load as a
teacher, request_preempt and SIGTERM stopping after the epoch with the
handler restored, debug_nans naming the module or Function, and a progress
bar that does not import tqdm."""

import dataclasses
import json
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_epoch_loops import _config, _trainer

from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.training import checkpoint as ckpt
from lmsu_tpu_torch.training.distill import _load_teacher_state
from lmsu_tpu_torch.training.monitor import NanGuard

torch.set_num_threads(2)


def _cfg(epochs=1, kd=None, **train):
    cfg = _config(kd, **train)
    return cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=epochs))


def _quiet(*a, **k):
    pass


def _history(d):
    with open(os.path.join(d, "training_history.json")) as f:
        return json.load(f)


def test_resume_from_async_run_and_files_equal_sync(tmp_path):
    runs = {}
    for name, on in (("sync", False), ("async", True)):
        tr = _trainer(_cfg(2, async_checkpoint=on), tmp=tmp_path / name)
        tr.train(log=_quiet)
        runs[name] = tr
        assert tr._async_ckpt is None  # flushed and closed at the end of train()
    for f in ("latest.pth", "best.pth"):
        if not (tmp_path / "sync" / f).exists():
            continue
        a, s = (ckpt.load_checkpoint(str(tmp_path / n / f)) for n in ("async", "sync"))
        assert a.keys() == s.keys() and a["epoch"] == s["epoch"]

        def equal(x, y):
            if isinstance(x, torch.Tensor):
                return torch.equal(x, y)
            if isinstance(x, dict):
                return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
            if isinstance(x, (list, tuple)):
                return len(x) == len(y) and all(equal(u, v) for u, v in zip(x, y))
            return x == y
        assert equal(a, s), f
    resumed = _trainer(_cfg(2, async_checkpoint=True), tmp=tmp_path / "async")
    assert resumed.load_checkpoint(str(tmp_path / "async" / "latest.pth")) == 2
    for k, p in runs["async"].params.items():
        assert torch.equal(resumed.params[k], p), k


def test_async_snapshot_survives_its_source_changing(tmp_path):
    """The device copy decouples the write from the state: the next steps
    update it in place, which must not reach the file."""
    ac = ckpt.AsyncCheckpointer()
    x = torch.arange(8.0)
    ac.save(str(tmp_path / "run"), {"state": {"w": x}}, 0, 0.5, is_best=True,
            snapshot=ckpt.snapshot_name(0))
    x.zero_()
    del x
    ac.wait()
    for name in ("latest.pth", "best.pth", "epoch_001.pth"):
        raw = ckpt.load_checkpoint(str(tmp_path / "run" / name))
        assert torch.equal(raw["state"]["w"], torch.arange(8.0))
        assert raw["epoch"] == 0 and raw["val_miou"] == 0.5
    ac.close()
    with pytest.raises(RuntimeError, match="closed"):
        ac.save(str(tmp_path / "run"), {}, 1, 0.0)


def test_worker_error_is_sticky_and_recoverable(tmp_path):
    ac = ckpt.AsyncCheckpointer()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")  # os.makedirs(save_dir) fails on a file
    ac.save(str(blocker), {"w": torch.zeros(4)}, 0, 0.0)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ac.wait()
    ac.save(str(tmp_path / "ok"), {"w": torch.ones(4)}, 1, 0.1)
    ac.close()
    assert (tmp_path / "ok" / "latest.pth").exists()


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_snapshots_every_n_epochs_load_as_teacher(tmp_path, use_async):
    cfg = _cfg(4, snapshot_every=2, async_checkpoint=use_async)
    _trainer(cfg, tmp=tmp_path).train(log=_quiet)
    for n in (2, 4):
        path = tmp_path / f"epoch_{n:03d}.pth"
        assert path.exists(), path
        assert ckpt.load_checkpoint(str(path))["epoch"] == n - 1
        create_model(cfg.model).load_state_dict(_load_teacher_state(str(path)), strict=True)
    assert not any((tmp_path / f"epoch_{n:03d}.pth").exists() for n in (1, 3))


def test_request_preempt_stops_after_the_epoch(tmp_path):
    tr = _trainer(_cfg(5), tmp=tmp_path)
    seen = []

    def log(msg=""):
        seen.append(str(msg))
        if str(msg).startswith("Epoch 2/"):
            tr.request_preempt()
    tr.train(log=log)
    assert len(_history(tmp_path)["val_miou"]) == 2
    assert any("Preempted" in m for m in seen)
    assert not any("Training completed" in m for m in seen)
    again = _trainer(_cfg(5), tmp=tmp_path)
    assert again.load_checkpoint(str(tmp_path / "latest.pth")) == 2


def test_sigterm_stops_cleanly_and_restores_the_handler(tmp_path):
    tr = _trainer(_cfg(4, handle_sigterm=True, async_checkpoint=True), tmp=tmp_path)
    prior = signal.getsignal(signal.SIGTERM)

    def log(msg=""):
        if str(msg).startswith("Epoch 1/"):
            os.kill(os.getpid(), signal.SIGTERM)  # delivered in this process
    tr.train(log=log)
    assert len(_history(tmp_path)["val_miou"]) == 1
    assert ckpt.load_checkpoint(str(tmp_path / "latest.pth"))["epoch"] == 0
    assert signal.getsignal(signal.SIGTERM) is prior
    # Off the main thread no handler can be installed: a warning, and the
    # run goes on.
    tr2 = _trainer(_cfg(1, handle_sigterm=True), tmp=tmp_path / "thread")
    caught = []

    def run():
        with pytest.warns(UserWarning, match="request_preempt"):
            tr2.train(log=_quiet)
        caught.append(True)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert caught == [True] and signal.getsignal(signal.SIGTERM) is prior


def test_debug_nans_names_the_module(tmp_path):
    """One point's intensity NaN: the first module whose forward produces a
    NaN is in the LiDAR encoder (the first PFN BatchNorm: the convolutions
    run functionally inside it)."""
    tr = _trainer(_cfg(1, kd={}, debug_nans=True), tmp=tmp_path)
    batch = next(iter(tr.train_loader))
    batch = {k: np.array(v) for k, v in batch.items()}
    batch["points"][0, 5, 3] = np.nan
    with pytest.raises(FloatingPointError, match=r"teacher\.lidar_encoder\.encoder\.pfn\.1 "):
        tr.train_step(batch)
    clean = _trainer(_cfg(1, kd={}, debug_nans=True), tmp=tmp_path)
    clean.train_step(next(iter(clean.train_loader)))  # finite: no error
    off = _trainer(_cfg(1, kd={}), tmp=tmp_path)
    assert off._nan_guard is None
    assert not np.isfinite(float(off.train_step(batch)[0]))


def test_debug_nans_names_the_backward_function():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    loss = torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x)).sum()
    with pytest.raises(FloatingPointError, match="SqrtBackward"):
        NanGuard.backward(loss, [("x", x)])


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_progress_bar_without_tqdm(tmp_path, monkeypatch, capsys, scan_steps):
    """A count per step on stderr; with scan_steps > 1 the running loss once
    a chunk, with 1 no loss at all (no read-back per step)."""
    monkeypatch.setitem(sys.modules, "tqdm", None)  # any import of tqdm fails
    tr = _trainer(_cfg(1, progress=True, scan_steps=scan_steps), tmp=tmp_path)
    tr.train(log=_quiet)
    err = capsys.readouterr().err
    assert "Training: 7/7" in err and "Validation: 3/3" in err
    assert ("loss" in err) == (scan_steps > 1)
    if scan_steps > 1:
        assert "Training: 3/7 loss" in err and "Training: 6/7 loss" in err
