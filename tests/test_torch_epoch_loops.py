"""The port's chained steps and on-device epochs (TrainConfig.scan_steps,
onchip_epoch, onchip_contiguous, onchip_eval; the JAX package's
trainer.py:348-620 and distill.py:557-686), on the CPU, with a small
weighted pillar student and its 2x teacher, 13 samples in batches of 2:
7 batches, the last one padded.

  * scan_steps = 3 (two chunks and a one-batch tail) equals scan_steps = 1
    bit for bit, for the CE trainer and the three KD variants (in-loop
    teacher, cache on the device, cache spilled to the host): the epoch's
    loss and mIoU, validation, every parameter and buffer. The port runs
    eagerly, so a chunk runs the ops of its single steps in order.
  * materialize_dataset equals the JAX package's array for array, with the
    cell sorter as sample_transform and without.
  * the on-device epoch (plain and contiguous; in-loop and with the device
    cache) equals the host path run over the same permuted batches bit for
    bit, and on-device validation equals host validation.
  * what the JAX package refuses stays refused: the spilled cache on the
    on-device epoch, onchip_epoch or onchip_eval=True without a Batcher.
Tolerance: none (same process, same ops)."""

import dataclasses

import numpy as np
import pytest
import torch

from lmsu_tpu.data.pipeline import materialize_dataset as jax_materialize
from lmsu_tpu_torch.common import build_loaders
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig)
from lmsu_tpu_torch.data import create_datasets, materialize_dataset
from lmsu_tpu_torch.data.rasterize import make_point_sorter
from lmsu_tpu_torch.training import DistillationTrainer, Trainer

torch.set_num_threads(2)

NUM_TRAIN, BATCH = 13, 2
TAPS = ("camera_feat", "post_fusion")
VARIANTS = {"ce": None, "in_loop": {}, "device_cache": {"cache_teacher": True},
            "host_spill": {"cache_teacher": True, "cache_hbm_limit_bytes": 0}}


def _config(kd=None, scatter="xla", **train):
    model = ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
                        camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                 grid_size=(8, 8), scatter_impl=scatter,
                                                 encoder_type="pointpillars"))
    data = DataConfig(image_size=(32, 32), grid_size=(8, 8), max_points=128,
                      batch_size=BATCH, synthetic_num_train=NUM_TRAIN, synthetic_num_val=5,
                      num_workers=0)
    kdc = (KDConfig(enabled=True, feature_taps=TAPS, **kd) if kd is not None
           else KDConfig(enabled=False))
    return ExperimentConfig(model=model, data=data, train=TrainConfig(
        num_epochs=1, lr=1e-3, save_dir="unused", kd=kdc, **train))


def _trainer(cfg, loaders=None, tmp=None):
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, save_dir=str(tmp or "unused")))
    cls = DistillationTrainer if cfg.train.kd.enabled else Trainer
    return cls(cfg, *(loaders or build_loaders(cfg, verbose=False)), device="cpu")


def _state(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()} | (
        {f"proj.{k}": v.detach().clone() for k, v in tr.proj.items()}
        if hasattr(tr, "proj") else {})


def _assert_same_run(a, b):
    (la, ma, va, sa), (lb, mb, vb, sb) = a, b
    assert la == lb and ma["miou"] == mb["miou"] and va == vb
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _epoch(tr, loader=None):
    loss, metrics = tr.train_epoch() if loader is None else tr._run_epoch(loader, True)
    return loss, metrics, tr.validate(), _state(tr)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_scan_steps_equal_single_steps(tmp_path, variant):
    kd = VARIANTS[variant]
    one = _trainer(_config(kd), tmp=tmp_path)
    chunked = _trainer(_config(kd, scan_steps=3), tmp=tmp_path)
    a, b = _epoch(one), _epoch(chunked)
    assert one.step == chunked.step == 7
    if variant == "host_spill":
        assert chunked.teacher_cache_host is not None
    _assert_same_run(a, b)


@pytest.mark.parametrize("sort", [False, True], ids=["plain", "cell_sorted"])
def test_materialize_dataset_matches_jax(sort):
    train, _ = create_datasets(_config().data)
    tf = make_point_sorter((8, 8), (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)) if sort else None
    got = materialize_dataset(train, 4, sample_transform=tf)
    want = jax_materialize(train, 4, sample_transform=tf)
    assert got.keys() == want.keys() and len(got["sample_mask"]) == 16
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (got["segmentation"][13:] == -1).all() and not got["sample_mask"][13:].any()


class _Permuted:
    """Host batches in the on-device epoch's order: rows of the
    materialized set by slices of its permutation."""

    def __init__(self, host, perm):
        self.host, self.perm = host, perm

    def __len__(self):
        return len(self.perm) // BATCH

    def __iter__(self):
        for i in range(len(self)):
            idx = self.perm[i * BATCH:(i + 1) * BATCH]
            yield {k: v[idx] for k, v in self.host.items()}


@pytest.mark.parametrize("contiguous", [False, True], ids=["gather", "contiguous"])
@pytest.mark.parametrize("kd", [{}, {"cache_teacher": True}], ids=["in_loop", "device_cache"])
def test_onchip_epoch_equals_host_path_in_its_order(tmp_path, contiguous, kd):
    cfg = _config(kd, scatter="sorted_pallas", onchip_epoch=True,
                  onchip_contiguous=contiguous)
    loaders = build_loaders(cfg, verbose=False)
    onchip = _trainer(cfg, loaders, tmp_path)
    onchip._epoch_index = 1  # the permutation of epoch 1
    got = _epoch(onchip)
    # The set on the device carries the loaders' cell sort.
    batcher = loaders[0].batcher
    host = materialize_dataset(batcher.dataset, BATCH, batcher.sample_transform)
    assert np.array_equal(onchip._onchip_data["points"].numpy(), host["points"])
    perm = np.random.default_rng(np.random.SeedSequence([0, 1, 104729])).permutation(14)
    ref = _trainer(cfg.replace(train=dataclasses.replace(cfg.train, onchip_epoch=False)),
                   loaders, tmp_path)
    want = _epoch(ref, _Permuted(host, perm))
    assert onchip.step == ref.step == 7 and onchip.last_host_stall_frac == 0.0
    _assert_same_run(got, want)


def test_onchip_eval_equals_host_eval(tmp_path):
    cfg = _config({}, onchip_eval=True)
    tr = _trainer(cfg, tmp=tmp_path)
    assert tr.validate() == tr._run_epoch(tr.val_loader, train=False)
    assert tr._onchip_val_data is not None


def test_refusals_kept_from_jax(tmp_path):
    spill = _trainer(_config(VARIANTS["host_spill"], onchip_epoch=True), tmp=tmp_path)
    with pytest.raises(NotImplementedError, match="HBM-resident"):
        spill.train_epoch()
    cfg = _config({}, onchip_epoch=True)
    _, val = build_loaders(cfg, verbose=False)
    with pytest.raises(ValueError, match="onchip_epoch needs a Batcher"):
        _trainer(cfg, ([{}], val), tmp_path).train_epoch()
    cfg = _config({}, onchip_eval=True)
    train, _ = build_loaders(cfg, verbose=False)
    with pytest.raises(ValueError, match="onchip_eval=True needs a Batcher"):
        _trainer(cfg, (train, [{}]), tmp_path).validate()
