"""The slice as a whole against the JAX package, on the CPU: the
cross-architecture recipe's pieces (scripts/experiment_crossarch_best.py)
at a small size. A PointPillars student (weighted fusion) distils from a
2x spatial teacher through the dataset-wide cache on the device, with the
recipe's noisy-student augmentation (photometric terms and point dropout;
JAX's draws fed to the port through its draw function). Two epochs of 16
samples in batches of 8 in one trainer on each side: the first with
scan_steps=2 (one chunk of two steps), the second with onchip_epoch (the
training set and the cache on the device, the permutation of epoch 1).

Held under the K-step protocol of tests/test_torch_kd_cache.py (that of
tests/test_dynamics_parity.py with the KD tests' spread): the caches within
1e-5 of scale; each epoch's loss, every parameter's update over the two
epochs and every BatchNorm statistic to a fixed margin plus 10x the JAX
run's own spread (the same two epochs from student weights moved by 1e-6
of themselves), capped; a tensor whose reference update is noise is held to
the size of the move."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_augment import jax_draws
from test_torch_pointpillars import to_jax_variables

from lmsu_tpu.config import AugmentConfig as JAug
from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import DataConfig as JData
from lmsu_tpu.config import ExperimentConfig as JExp
from lmsu_tpu.config import KDConfig as JKD
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import TrainConfig as JTrain
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.data import create_datasets as jax_create_datasets
from lmsu_tpu.data import make_loader as jax_make_loader
from lmsu_tpu.training import distill as jax_distill_module
from lmsu_tpu.training import trainer as jax_trainer_module
from lmsu_tpu.training.distill import DistillationTrainer as JaxDistillationTrainer
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.common import build_loaders
from lmsu_tpu_torch.config import (AugmentConfig, CameraEncoderConfig, DataConfig,
                                   ExperimentConfig, KDConfig, LidarEncoderConfig,
                                   ModelConfig, TrainConfig, teacher_config)
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.ops import augment
from lmsu_tpu_torch.training import DistillationTrainer
from lmsu_tpu_torch.utils.weights import from_jax_projections, from_jax_variables

torch.set_num_threads(2)

NUM_TRAIN, BATCH, LR = 16, 8, 1e-3
STEPS = 2 * (NUM_TRAIN // BATCH)
TAPS = ("camera_feat", "lidar_feat", "post_fusion")
RECIPE = dict(brightness=0.1, contrast=0.1, image_noise_std=0.02, point_dropout=0.05)
LIDAR = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8), encoder_type="pointpillars")
MODEL = dict(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
             camera_fpn_channels=16)


def _port_config(save_dir):
    model = ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(**LIDAR), **MODEL)
    data = DataConfig(image_size=(32, 32), grid_size=(8, 8), max_points=128,
                      batch_size=BATCH, synthetic_num_train=NUM_TRAIN, synthetic_num_val=8,
                      num_workers=0)
    train = TrainConfig(num_epochs=2, lr=LR, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                        scan_steps=2, augment=AugmentConfig(enabled=True, **RECIPE),
                        kd=KDConfig(enabled=True, feature_taps=TAPS, temperature=4.0,
                                    cache_teacher=True))
    return ExperimentConfig(model=model, data=data, train=train)


def _port_teacher(model_cfg):
    t = teacher_config(model_cfg, 2.0)
    return t.replace(lidar=dataclasses.replace(t.lidar, encoder_type="spatial"))


def _jax_config(save_dir):
    model = JModel(camera=JCam(base_channels=4), lidar=JLidar(**LIDAR), **MODEL)
    data = JData(dataset="synthetic", synthetic_num_train=NUM_TRAIN, synthetic_num_val=8,
                 image_size=(32, 32), grid_size=(8, 8), max_points=128, batch_size=BATCH)
    train = JTrain(num_epochs=2, lr=LR, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                   scan_steps=2, augment=JAug(enabled=True, **RECIPE),
                   kd=JKD(enabled=True, feature_taps=TAPS, temperature=4.0, cache_teacher=True))
    return JExp(model=model, data=data, train=train)


def _onchip(cfg):
    return cfg.replace(train=dataclasses.replace(cfg.train, onchip_epoch=True))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's two epochs from the port's seeded weights (carried
    by the converters; the student's PFN under the spatial names), then the
    same two epochs from the student's weights moved by 1e-6 of themselves
    (same trainer: the cache and the compiled steps are reused)."""
    cfg = _jax_config(tmp_path_factory.mktemp("jax"))
    pcfg = _port_config("")
    jt = _port_teacher(pcfg.model)
    jtcfg = jax_teacher_config(cfg.model, 2.0)
    jtcfg = jtcfg.replace(lidar=dataclasses.replace(jtcfg.lidar, encoder_type="spatial"))
    made = {cfg.model: to_jax_variables(create_model(pcfg.model, seed=0).state_dict(),
                                        cfg.model),
            jtcfg: convert_torch_state_dict(create_model(jt, seed=1).state_dict(), jtcfg)}
    train_ds, val_ds = jax_create_datasets(cfg.data)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_trainer_module, jax_distill_module):
            mp.setattr(mod, "init_model", lambda model, rng, **kw: made[model.config])
        tr = JaxDistillationTrainer(cfg, jax_make_loader(train_ds, BATCH, shuffle=True, seed=0),
                                    jax_make_loader(val_ds, BATCH, shuffle=False),
                                    teacher_model_config=jtcfg)
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    init = get(tr.state)
    out = {"init": init, "teacher": get(tr.teacher_variables)}

    def two_epochs(state):
        tr.state = jax.device_put(state)
        tr.config = cfg
        tr.train_loader.set_epoch(0)
        l1, _ = tr.train_epoch()
        tr.config = _onchip(cfg)
        tr.train_loader.set_epoch(1)
        l2, _ = tr.train_epoch()
        s = get(tr.state)
        return {"loss": (float(l1), float(l2)), "params": s.params, "stats": s.batch_stats}

    out["ref"] = two_epochs(init)
    out["cache"] = get(tr.teacher_cache)
    noise = np.random.default_rng(3)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
        init.params)
    out["perturbed"] = two_epochs(init.replace(params=moved))
    return out


def _flat(params, stats, cfg):
    sd = from_jax_variables({"params": params["model"], "batch_stats": stats}, cfg)
    return {**{f"model.{k}": v for k, v in sd.items()},
            **{f"proj.{k}": v for k, v in from_jax_projections(params["proj"]).items()}}


def test_crossarch_chunked_then_onchip_epochs_match_jax(jax_run, tmp_path, monkeypatch):
    cfg = _port_config(tmp_path)
    tcfg = _port_teacher(cfg.model)
    loaders = build_loaders(cfg, verbose=False)
    tr = DistillationTrainer(cfg, *loaders, teacher_model_config=tcfg, device="cpu",
                             teacher_state_dict=from_jax_variables(jax_run["teacher"], tcfg))
    assert tr.teacher.lidar_encoder.encoder.__class__.__name__ == "SpatialLiDAREncoder"
    assert tr.model.lidar_encoder.encoder.__class__.__name__ == "PointPillarsLiDAREncoder"
    init = jax_run["init"]
    tr.model.load_state_dict(from_jax_variables(
        {"params": init.params["model"], "batch_stats": init.batch_stats}, cfg.model))
    with torch.no_grad():
        for tap, p in from_jax_projections(init.params["proj"]).items():
            tr.proj[tap].copy_(p)
    seed = cfg.train.seed

    def jax_step_draws(gen, aug, b):
        key = jax.random.fold_in(jax.random.PRNGKey(seed ^ aug.seed_offset), tr.step)
        return jax_draws(key, aug, tuple(b["image"].shape), tuple(b["points"].shape))
    monkeypatch.setattr(augment, "draw_augment", jax_step_draws)
    loaders[0].set_epoch(0)
    l1, _ = tr.train_epoch()
    tr.config = _onchip(cfg)
    loaders[0].set_epoch(1)
    l2, _ = tr.train_epoch()
    assert tr.step == STEPS and tr._onchip_data is not None

    for k, want in jax_run["cache"].items():
        got = tr.teacher_cache[k]
        got = got.numpy() if k == "logits" else got.permute(0, 2, 3, 1).numpy()
        assert np.abs(got - want).max() <= 1e-5 * float(np.abs(want).max()), k

    ref, pert = jax_run["ref"], jax_run["perturbed"]
    counts, noise_moves = {}, []

    def held(kind, name, err, fixed, noise, cap):
        tol = fixed + min(10 * noise, cap)
        assert err <= tol, (f"{kind} {name}: {err:g} > {tol:g} (fixed {fixed:g}, "
                            f"reference spread {noise:g}, cap {cap:g})")
        c = counts.setdefault(kind, [0, 0, 0])
        c[0] += 1
        c[1] += int(err > fixed)
        c[2] += int(noise > fixed)

    for i, got in enumerate((l1, l2)):
        w = ref["loss"][i]
        held("loss", f"epoch {i + 1}", abs(got - w), 1e-6 * abs(w), abs(pert["loss"][i] - w),
             1e-4 * abs(w))
    start = _flat(init.params, init.batch_stats, cfg.model)
    want = _flat(ref["params"], ref["stats"], cfg.model)
    spread = _flat(pert["params"], pert["stats"], cfg.model)
    for k, p in tr.params.items():
        d_ref = (want[k] - start[k]).norm()
        noise = float((spread[k] - want[k]).norm() / d_ref)
        if noise > 0.3:  # the reference's own update is noise: hold its size
            noise_moves.append(k)
            assert float((p.detach() - want[k]).abs().max()) <= 2 * STEPS * LR, k
            continue
        held("update", k, float((p.detach() - want[k]).norm() / d_ref), 1e-2, noise, 0.3)
    for k, v in tr.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            w = want[f"model.{k}"]
            scale = float(w.abs().max())
            err = float((v - w).abs().max())
            noise = float((spread[f"model.{k}"] - w).abs().max())
            bn = k.rsplit(".", 1)[0]
            conv = f"model.{bn[:-1]}{int(bn[-1]) - 1}.weight" if bn[-1].isdigit() else None
            if k.endswith("running_mean") and noise > 1e-6 + 1e-2 * scale and conv in start:
                # A running mean that absorbs a noise move of the layer before.
                rows = float(start[conv].abs().flatten(1).sum(1).max())
                noise_moves.append(k)
                assert err <= 2 * STEPS * LR * max(1.0, rows), (k, err, rows)
                continue
            held("stat", k, err, 1e-6 + 1e-4 * scale, noise, 1e-6 + 1e-2 * scale)
    print(f"tensors checked / port error above the fixed margin / reference spread "
          f"above it: {counts}; held to the size of the move: {noise_moves}")
    assert len(noise_moves) <= 16, noise_moves
    for kind, (n, port_over, ref_over) in counts.items():
        assert port_over <= ref_over, (kind, counts)
