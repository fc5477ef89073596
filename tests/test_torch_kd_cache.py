"""The dataset-wide teacher cache of the port's DistillationTrainer
(KDConfig.cache_teacher), on the CPU, at the JAX package's tiny KD size
(tests/test_kd.py::_tiny_cfg: concat/32 student, 2x teacher, 32^2 images,
128 points, 8x8 grid; 20 samples in batches of 8, the last one padded).

  * a cached epoch equals an in-loop epoch, and the host spill
    (cache_hbm_limit_bytes=0) gathers the device cache's targets bit for
    bit and gives the same epoch (same process, same ops: no tolerance);
  * the bf16 cache stores bf16 rows and stays within 1e-2 of the f32 loss;
  * a loader that misses samples fails the fill;
  * one port epoch with the cache and the recipe's noisy-student
    augmentation (photometric terms and point dropout) against the JAX
    package's DistillationTrainer(cache_teacher=True) on the same data and
    weights (from_jax_variables), JAX's augmentation draws fed to the port
    through its draw function. The caches: within 1e-5 of scale (f32 eval
    forwards). The epoch loss, updates and BatchNorm statistics: the limits
    of tests/test_torch_kd_step.py, a fixed margin plus 10x the reference's
    own spread (the same epoch from student weights moved by 1e-6 of
    themselves), capped; a tensor whose reference update is noise (the
    reference's own update moves by more than the cap under that
    perturbation: biases that a train-mode BatchNorm cancels) is held to
    the size of the move, 2 * steps * lr.
"""


import jax
import numpy as np
import pytest
import torch
from test_torch_augment import jax_draws

from lmsu_tpu.config import AugmentConfig as JAug
from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import DataConfig as JData
from lmsu_tpu.config import ExperimentConfig as JExp
from lmsu_tpu.config import KDConfig as JKD
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import TrainConfig as JTrain
from lmsu_tpu.data import create_datasets as jax_create_datasets
from lmsu_tpu.data import make_loader as jax_make_loader
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.training import distill as jax_distill_module
from lmsu_tpu.training import trainer as jax_trainer_module
from lmsu_tpu.training.distill import DistillationTrainer as JaxDistillationTrainer
from lmsu_tpu_torch.common import build_loaders
from lmsu_tpu_torch.config import (AugmentConfig, CameraEncoderConfig, DataConfig,
                                   ExperimentConfig, KDConfig, LidarEncoderConfig,
                                   ModelConfig, TrainConfig, teacher_config)
from lmsu_tpu_torch.data import make_loader
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.ops import augment
from lmsu_tpu_torch.training import DistillationTrainer
from lmsu_tpu_torch.utils.weights import from_jax_projections, from_jax_variables

torch.set_num_threads(2)

NUM_TRAIN, BATCH, LR = 20, 8, 1e-3
STEPS = -(-NUM_TRAIN // BATCH)
TAPS = ("camera_feat", "post_fusion")
RECIPE = dict(brightness=0.1, contrast=0.1, image_noise_std=0.02, point_dropout=0.05)


def _model_kw():
    return dict(num_classes=2, fusion_type="concat", fusion_out_channels=32,
                camera_fpn_channels=16)


def _config(save_dir, aug=None, **kd):
    model = ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                 grid_size=(8, 8)), **_model_kw())
    data = DataConfig(image_size=(32, 32), grid_size=(8, 8), max_points=128,
                      batch_size=BATCH, synthetic_num_train=NUM_TRAIN, synthetic_num_val=8,
                      num_workers=0)
    train = TrainConfig(num_epochs=1, lr=LR, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                        augment=AugmentConfig(enabled=True, **aug) if aug else AugmentConfig(),
                        kd=KDConfig(enabled=True, feature_taps=TAPS, **kd))
    return ExperimentConfig(model=model, data=data, train=train)


def _trainer(save_dir, aug=None, loaders=None, **kd):
    cfg = _config(save_dir, aug, **kd)
    return DistillationTrainer(cfg, *(loaders or build_loaders(cfg, verbose=False)),
                               device="cpu")


def _state(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()} | \
        {f"proj.{k}": v.detach().clone() for k, v in tr.proj.items()}


@pytest.fixture(scope="module")
def in_loop(tmp_path_factory):
    tr = _trainer(tmp_path_factory.mktemp("inloop"))
    loss, metrics = tr.train_epoch()
    return loss, metrics, _state(tr)


@pytest.mark.parametrize("limit", [4 << 30, 0], ids=["device", "host_spill"])
def test_cached_epoch_equals_in_loop_epoch(in_loop, tmp_path, limit):
    tr = _trainer(tmp_path, cache_teacher=True, cache_hbm_limit_bytes=limit)
    loss, metrics = tr.train_epoch()
    on_device = limit > 0
    assert (tr.teacher_cache is not None) == on_device
    assert (tr.teacher_cache_host is not None) != on_device
    cache = tr.teacher_cache if on_device else tr.teacher_cache_host
    assert set(cache) == {"logits", *TAPS}
    assert all(v.shape[0] == NUM_TRAIN and v.dtype == torch.float32 for v in cache.values())
    want_loss, want_metrics, want_state = in_loop
    assert loss == want_loss and metrics["miou"] == want_metrics["miou"]
    for k, v in _state(tr).items():
        assert torch.equal(v, want_state[k]), k


def test_host_spill_gathers_the_device_cache_rows(tmp_path, capsys):
    cfg = _config(tmp_path)
    loaders = build_loaders(cfg, verbose=False)
    dev = _trainer(tmp_path, loaders=loaders, cache_teacher=True)
    host = _trainer(tmp_path, loaders=loaders, cache_teacher=True, cache_hbm_limit_bytes=0)
    dev.build_teacher_cache()
    host.build_teacher_cache()
    out = capsys.readouterr().out
    assert "on the device" in out and "spilling to host RAM" in out
    for k, v in dev.teacher_cache.items():
        assert torch.equal(v, host.teacher_cache_host[k]), k
    batch = next(iter(loaders[0]))
    b = dev._to_device(batch)
    got, want = host.gather_teacher(batch, b), dev.gather_teacher(batch, b)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][t], want[1][t]) for t in TAPS)
    # The gathered rows are the teacher's outputs for this batch.
    logits, taps = dev.teacher_forward(b)
    assert torch.equal(want[0], logits) and all(torch.equal(want[1][t], taps[t]) for t in TAPS)


def test_bf16_cache(in_loop, tmp_path):
    tr = _trainer(tmp_path, cache_teacher=True, cache_dtype="bfloat16")
    loss, _ = tr.train_epoch()
    assert all(v.dtype == torch.bfloat16 for v in tr.teacher_cache.values())
    want = in_loop[0]
    assert loss != want and abs(loss - want) <= 1e-2 * abs(want)
    with pytest.raises(ValueError, match="cache_dtype"):
        _trainer(tmp_path, cache_teacher=True, cache_dtype="float16")


def test_fill_fails_when_the_loader_misses_samples(tmp_path):
    cfg = _config(tmp_path)
    train, val = build_loaders(cfg, verbose=False)
    short = make_loader(train.batcher.dataset, BATCH, shuffle=True, drop_last=True)
    tr = _trainer(tmp_path, loaders=(short, val), cache_teacher=True)
    with pytest.raises(AssertionError, match="missed samples"):
        tr.train_epoch()
    with pytest.raises(ValueError, match="Batcher"):
        _trainer(tmp_path, loaders=([], val), cache_teacher=True).build_teacher_cache()


# -- against the JAX package ---------------------------------------------------


def _jax_config(save_dir):
    model = JModel(camera=JCam(base_channels=4),
                   lidar=JLidar(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8)),
                   **_model_kw())
    data = JData(dataset="synthetic", synthetic_num_train=NUM_TRAIN, synthetic_num_val=8,
                 image_size=(32, 32), grid_size=(8, 8), max_points=128, batch_size=BATCH)
    train = JTrain(num_epochs=1, lr=LR, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                   augment=JAug(enabled=True, **RECIPE),
                   kd=JKD(enabled=True, feature_taps=TAPS, cache_teacher=True))
    return JExp(model=model, data=data, train=train)


@pytest.fixture(scope="module")
def jax_epoch(tmp_path_factory):
    """The JAX trainer's cached, augmented epoch from its own initial
    weights, then the same epoch from the student's weights moved by 1e-6
    of themselves (the cache and the teacher unchanged)."""
    cfg = _jax_config(tmp_path_factory.mktemp("jax"))
    train_ds, val_ds = jax_create_datasets(cfg.data)

    # Seeded weights made by the port and carried to the JAX package by its
    # own converter (the student from seed 0, the teacher from seed 1, as
    # both trainers draw them): building them in JAX would compile the
    # initialisers for half a minute here.
    tcfg = teacher_config(_config("").model, 2.0)
    made = {cfg.model: convert_torch_state_dict(create_model(_config("").model, seed=0)
                                                .state_dict(), cfg.model),
            jax_teacher_config(cfg.model, 2.0): convert_torch_state_dict(
                create_model(tcfg, seed=1).state_dict(), jax_teacher_config(cfg.model, 2.0))}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_trainer_module, jax_distill_module):
            mp.setattr(mod, "init_model", lambda model, rng, **kw: made[model.config])
        tr = JaxDistillationTrainer(cfg, jax_make_loader(train_ds, BATCH, shuffle=True, seed=0),
                                    jax_make_loader(val_ds, BATCH, shuffle=False))
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    init = get(tr.state)
    out = {"init": init, "teacher": get(tr.teacher_variables)}

    def epoch(state):
        tr.state = jax.device_put(state)
        loss, _ = tr.train_epoch()
        s = get(tr.state)
        return {"loss": float(loss), "params": s.params, "stats": s.batch_stats}

    out["ref"] = epoch(init)
    out["cache"] = get(tr.teacher_cache)
    noise = np.random.default_rng(3)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
        init.params)
    out["perturbed"] = epoch(init.replace(params=moved))
    return out


def _flat(params, stats, cfg):
    sd = from_jax_variables({"params": params["model"], "batch_stats": stats}, cfg)
    return {**{f"model.{k}": v for k, v in sd.items()},
            **{f"proj.{k}": v for k, v in from_jax_projections(params["proj"]).items()}}


def test_cached_augmented_epoch_matches_jax(jax_epoch, tmp_path, monkeypatch):
    cfg = _config(tmp_path, RECIPE, cache_teacher=True)
    teacher_sd = from_jax_variables(jax_epoch["teacher"], teacher_config(cfg.model, 2.0))
    tr = DistillationTrainer(cfg, *build_loaders(cfg, verbose=False), device="cpu",
                             teacher_state_dict=teacher_sd)
    init = jax_epoch["init"]
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
    loss, _ = tr.train_epoch()
    assert tr.step == STEPS

    # The caches: the same teacher on the same clean samples.
    for k, want in jax_epoch["cache"].items():
        got = tr.teacher_cache[k]
        got = got.numpy() if k == "logits" else got.permute(0, 2, 3, 1).numpy()
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-5 * scale, k

    ref, pert = jax_epoch["ref"], jax_epoch["perturbed"]
    counts = {}

    def held(kind, name, err, fixed, noise, cap):
        tol = fixed + min(10 * noise, cap)
        assert err <= tol, (f"{kind} {name}: {err:g} > {tol:g} (fixed {fixed:g}, "
                            f"reference spread {noise:g}, cap {cap:g})")
        c = counts.setdefault(kind, [0, 0, 0])
        c[0] += 1
        c[1] += int(err > fixed)
        c[2] += int(noise > fixed)

    held("loss", "epoch", abs(loss - ref["loss"]), 1e-6 * abs(ref["loss"]),
         abs(pert["loss"] - ref["loss"]), 1e-4 * abs(ref["loss"]))
    start = _flat(init.params, init.batch_stats, cfg.model)
    want = _flat(ref["params"], ref["stats"], cfg.model)
    spread = _flat(pert["params"], pert["stats"], cfg.model)
    noise_moves = []
    for k, p in tr.params.items():
        d_ref = (want[k] - start[k]).norm()
        noise = float((spread[k] - want[k]).norm() / d_ref)
        if noise > 0.3:
            # The reference's own update is noise here: only the size of
            # the move is held.
            noise_moves.append(k)
            assert float((p.detach() - want[k]).abs().max()) <= 2 * STEPS * LR, k
            continue
        held("update", k, float((p.detach() - want[k]).norm() / d_ref), 1e-2, noise, 0.3)
    for k, v in tr.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            w = want[f"model.{k}"]
            scale = float(w.abs().max())
            err, noise = float((v - w).abs().max()), float((spread[f"model.{k}"] - w).abs().max())
            bn = k.rsplit(".", 1)[0]
            conv = f"model.{bn[:-1]}{int(bn[-1]) - 1}.weight" if bn[-1].isdigit() else None
            if k.endswith("running_mean") and noise > 1e-6 + 1e-2 * scale and conv in start:
                # A running mean that absorbs a noise move of the layer
                # before: held to the largest shift such a move can give,
                # every input channel moved by 2 * steps * lr through |W|.
                rows = float(start[conv].abs().flatten(1).sum(1).max())
                noise_moves.append(k)
                assert err <= 2 * STEPS * LR * max(1.0, rows), (k, err, rows)
                continue
            held("stat", k, float((v - w).abs().max()), 1e-6 + 1e-4 * scale,
                 float((spread[f"model.{k}"] - w).abs().max()), 1e-6 + 1e-2 * scale)
    print(f"tensors checked / port error above the fixed margin / reference spread "
          f"above it: {counts}; held to the size of the move: {noise_moves}")
    assert len(noise_moves) <= 16, noise_moves
    for kind, (n, port_over, ref_over) in counts.items():
        assert port_over <= ref_over, (kind, counts)
