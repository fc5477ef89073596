"""The port's DistillationTrainer end to end on the CPU: tiny synthetic data
through the training CLI's loaders (cell-sorted points, a padded final
batch), two epochs with the slice's kernel opt-ins (their plain versions
here), training_history.json with the reference schema, latest/best
checkpoints, and a run stopped after its first epoch that resumes from
latest.pth and ends exactly where the uninterrupted run ends. Tolerance:
none, the resumed run is compared bit for bit (same process, same ops)."""

import json

import numpy as np
import pytest
import torch

from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig)
from lmsu_tpu_torch.train_distill import build_loaders
from lmsu_tpu_torch.training import DistillationTrainer
from lmsu_tpu_torch.training.schedule import lr_at_epoch

torch.set_num_threads(2)

EPOCHS, NUM_TRAIN, BATCH = 2, 10, 4   # 10 samples: the third batch is padded


def _config(save_dir):
    model = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
                        camera_fpn_channels=16, use_pallas_fusion=True,
                        camera=CameraEncoderConfig(base_channels=8),
                        lidar=LidarEncoderConfig(feature_dim=32, mlp_dims=(16, 32),
                                                 grid_size=(16, 16),
                                                 scatter_impl="sorted_pallas"))
    data = DataConfig(image_size=(64, 64), grid_size=(16, 16), max_points=512,
                      batch_size=BATCH, synthetic_num_train=NUM_TRAIN, synthetic_num_val=6,
                      num_workers=0)
    train = TrainConfig(num_epochs=EPOCHS, save_dir=str(save_dir), grad_clip_norm=1.0,
                        kd=KDConfig(enabled=True, use_pallas=True))
    return ExperimentConfig(model=model, data=data, train=train)


def _trainer(save_dir):
    cfg = _config(save_dir)
    train_loader, val_loader = build_loaders(cfg, verbose=False)
    return DistillationTrainer(cfg, train_loader, val_loader, device="cpu")


class _Stop(Exception):
    pass


def _stop_at_second_epoch(msg):
    """A log that ends the run when epoch 2 reports, before its checkpoint."""
    if msg.startswith(f"Epoch 2/{EPOCHS}"):
        raise _Stop


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("full")
    tr = _trainer(d)
    logs = []
    best = tr.train(log=logs.append)
    return d, tr, best, logs


def test_epochs_write_history_and_checkpoints(full_run):
    d, tr, best, logs = full_run
    assert tr.steps_per_epoch == 3 and tr.step == EPOCHS * 3
    hist = json.loads((d / "training_history.json").read_text())
    assert set(hist) == {"train_loss", "train_miou", "val_loss", "val_miou", "lr"}
    assert all(len(v) == EPOCHS for v in hist.values())
    assert all(np.isfinite(v).all() for v in hist.values())
    cfg = tr.config.train
    assert hist["lr"] == [lr_at_epoch(cfg.lr, cfg.eta_min, EPOCHS, e + 1) for e in range(EPOCHS)]
    assert best == max(hist["val_miou"]) and best > 0.0
    latest = torch.load(d / "latest.pth", weights_only=False)
    assert {"model_state", "proj", "optimizer", "step", "epoch", "val_miou"} <= set(latest)
    assert latest["epoch"] == EPOCHS - 1 and latest["step"] == tr.step
    assert set(latest["proj"]) == set(cfg.kd.feature_taps)
    best_ckpt = torch.load(d / "best.pth", weights_only=False)
    assert best_ckpt["val_miou"] == best
    assert any("New best mIoU" in m for m in logs)


def test_resumed_run_ends_where_the_full_run_ends(full_run, tmp_path):
    _, full, _, _ = full_run
    first = _trainer(tmp_path)
    with pytest.raises(_Stop):
        first.train(log=_stop_at_second_epoch)
    assert torch.load(tmp_path / "latest.pth", weights_only=False)["epoch"] == 0

    resumed = _trainer(tmp_path)
    start = resumed.load_checkpoint(str(tmp_path / "latest.pth"))
    assert start == 1 and resumed.step == 3
    assert len(resumed.history.history["val_miou"]) == 1
    resumed.train(start, log=lambda msg: None)
    assert resumed.step == full.step
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    full_hist = full.history.history
    assert resumed.history.history["val_miou"] == full_hist["val_miou"]
    assert resumed.history.history["train_loss"] == full_hist["train_loss"]


@pytest.mark.parametrize("option,field", [
    ("onchip_epoch", dict(onchip_epoch=True)),
    ("onchip_eval", dict(onchip_eval=True)),
    ("onchip_spill", dict(onchip_epoch=True)),
    ("augment", "augment"),
    ("cache_teacher", dict(cache_teacher=True)),
    ("ensemble", dict(ensemble_size=2)),
    ("teacher_partition", dict(teacher_partition="sp")),
    ("MeshConfig", "mesh"),
])
def test_unported_options_are_refused_by_name(tmp_path, option, field):
    """Every option is ported (MeshConfig.model_parallel > 1, the 2-D mesh,
    since tests/test_torch_parallel_2d.py) and each is refused, by name,
    where the JAX package refuses it: a model_parallel that does not divide
    the ranks (ValueError, JAX's words: on one process 2 does not), the "sp"
    teacher partition on the 1-D mesh (ValueError: it needs a model axis;
    "fsdp" and "tp" are ported, tests/test_torch_parallel_kd.py), a point-moving
    augmentation term with the sorted scatter, the flip with the cache, one
    state dict for a two-member ensemble (ValueError); the on-device epoch
    or validation over a loader without a Batcher (ValueError), and the
    on-device epoch with the host-spilled teacher cache
    (NotImplementedError). scan_steps, SIGTERM handling, async and snapshot
    checkpoints are ported and refuse nothing (tests/test_torch_epoch_loops.py,
    tests/test_torch_run_control.py)."""
    import dataclasses

    from lmsu_tpu_torch.config import AugmentConfig, MeshConfig
    cfg = _config(tmp_path)
    tc = cfg.train
    teacher_sd, error = None, NotImplementedError
    if field == "augment":
        cfg = cfg.replace(train=dataclasses.replace(
            tc, augment=AugmentConfig(enabled=True, point_dropout=0.05)))
        option, error = "sorted_pallas", ValueError
    elif field == "mesh":
        cfg = cfg.replace(mesh=MeshConfig(model_parallel=2))
        option, error = "model_parallel=2 does not divide 1 devices", ValueError
    elif option in ("cache_teacher", "ensemble", "teacher_partition"):
        cfg = cfg.replace(train=dataclasses.replace(tc, kd=dataclasses.replace(tc.kd, **field)))
        if option == "teacher_partition":
            option, error = "teacher_partition='sp' needs a model axis", ValueError
        elif option == "cache_teacher":
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, augment=AugmentConfig(enabled=True, hflip_prob=0.5)),
                model=cfg.model.replace(lidar=dataclasses.replace(cfg.model.lidar,
                                                                  scatter_impl="pallas")))
            error = ValueError
        elif option == "ensemble":
            from lmsu_tpu_torch.config import teacher_config
            from lmsu_tpu_torch.models import create_model
            teacher_sd = create_model(teacher_config(cfg.model, 2.0)).state_dict()
            error = ValueError
    else:
        # The on-device loops: refused when the loop starts, as in JAX.
        cfg = cfg.replace(train=dataclasses.replace(tc, **field))
        if option == "onchip_spill":
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, kd=dataclasses.replace(
                tc.kd, cache_teacher=True, cache_hbm_limit_bytes=0)))
            tr = DistillationTrainer(cfg, *build_loaders(cfg, verbose=False), device="cpu")
            with pytest.raises(NotImplementedError, match="host-spilled cache"):
                tr.train_epoch()
            return
        tr = DistillationTrainer(cfg, [], [], device="cpu")
        with pytest.raises(ValueError, match=f"{option}.*Batcher"):
            tr.train_epoch() if option == "onchip_epoch" else tr.validate()
        return
    match = {"ensemble": "ensemble"}.get(option, option)
    with pytest.raises(error, match=match):
        DistillationTrainer(cfg, [], [], device="cpu", teacher_state_dict=teacher_sd)


def test_ce_trainer_evaluates_with_ema_weights(tmp_path):
    """The CE Trainer (the CLI's --train-teacher phase) trains an epoch; with
    ema_decay=1.0 the EMA weights stay the initial ones, so validate() must
    equal the initial weights evaluated with the trained BN statistics."""
    import dataclasses

    from lmsu_tpu_torch.models import create_model
    from lmsu_tpu_torch.training import Trainer
    cfg = _config(tmp_path)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1, ema_decay=1.0,
                                                kd=KDConfig(enabled=False)))
    train_loader, val_loader = build_loaders(cfg, verbose=False)
    tr = Trainer(cfg, train_loader, val_loader, device="cpu")
    tr.train(log=lambda msg: None)
    assert tr.step == 3
    val_loss, val_metrics = tr.validate()

    init = create_model(cfg.model, seed=cfg.train.seed)
    assert not all(torch.equal(p, q) for p, q in zip(init.parameters(), tr.model.parameters()))
    init.load_state_dict({**init.state_dict(), **dict(tr.model.named_buffers())})
    ref = Trainer(cfg, train_loader, val_loader, device="cpu", model=init)
    ref_loss, ref_metrics = ref.validate()
    assert val_loss == ref_loss and val_metrics["miou"] == ref_metrics["miou"]


@pytest.mark.parametrize("impl", ["xla", "xla_fastbwd", "sorted", "pallas", "sorted_pallas"])
def test_train_distill_cli_takes_each_scatter_impl(tmp_path, monkeypatch, impl):
    """The training CLI takes the JAX CLIs' five --scatter-impl values into
    the model config; only sorted_pallas turns on the loaders' by-cell point
    sort. With pallas, one epoch at width 0.25 on the CPU writes the history
    and both checkpoints."""
    from lmsu_tpu_torch import train_distill
    from lmsu_tpu_torch.data import rasterize
    argv = ["--device", "cpu", "--scatter-impl", impl, "--epochs", "1", "--num-train", "8",
            "--num-val", "4", "--width", "0.25", "--num-workers", "0",
            "--save-dir", str(tmp_path)]
    cfg, _ = train_distill.build_configs(train_distill.make_parser().parse_args(argv))
    assert cfg.model.lidar.scatter_impl == impl
    sorters = []
    real = rasterize.make_point_sorter
    monkeypatch.setattr(rasterize, "make_point_sorter",
                        lambda *a: sorters.append(a) or real(*a))
    if impl == "pallas":
        train_distill.main(argv)
        hist = json.loads((tmp_path / "training_history.json").read_text())
        assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"]).all()
        assert {"latest.pth", "best.pth"} <= {f.name for f in tmp_path.iterdir()}
    else:
        train_distill.build_loaders(cfg, verbose=False)
    assert bool(sorters) == (impl == "sorted_pallas")
