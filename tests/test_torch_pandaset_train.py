"""train_pandaset's trainer against the JAX Trainer, on the CPU: the
pandaset preset's head and losses at narrow widths (concat fusion, 3
classes over 2-class labels, class weights (0.39, 2.61, 33.09), 2-class
metrics) trained from a tiny pack of the fabricated PandaSet tree
(tests/test_torch_pandaset.py), whose 700-point clouds are padded to 900
points with point_valid marking the pad, with the sorted scatter (its plain
versions here; the JAX Pallas kernels in interpret mode).

Two train steps from the same weights on the same batches, then one
validation pass. Tolerances, those of
tests/test_torch_fusion_variants.py::test_train_step_matches_jax for a
train-mode CE step: each step's loss within atol 1e-4, rtol 1e-5; every
parameter gradient of each step within atol 5e-3, rtol 1e-4, plus 10x the
reference's own spread N (the same steps from weights moved by 1e-6 of
themselves; max over the tensor), capped at 0.1 max|g| but never below N;
the 2-class confusion matrices of both steps and of validation equal
exactly (so is the mIoU), the validation loss within atol 1e-4, rtol 1e-5.
The third logit wins some pixels, which the 2-class matrix leaves out on
both sides."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_pandaset import SCENES, make_pandaset_tree

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import DataConfig as JData
from lmsu_tpu.config import ExperimentConfig as JExp
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import MeshConfig as JMesh
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import TrainConfig as JTrain
from lmsu_tpu.config import preset_pandaset_weighted as jax_preset
from lmsu_tpu.training import trainer as jax_trainer_module
from lmsu_tpu_torch.common import build_loaders
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   LidarEncoderConfig, ModelConfig, TrainConfig,
                                   preset_pandaset_weighted)
from lmsu_tpu_torch.data import PandaSetDataset, write_pack
from lmsu_tpu_torch.ops.metrics import iou_from_confusion
from lmsu_tpu_torch.training import Trainer
from lmsu_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

IMG, GRID, NPTS, BATCH = (32, 32), (8, 8), 900, 2
MODEL = dict(num_classes=3, fusion_type="concat", fusion_out_channels=32, camera_fpn_channels=16)
LIDAR = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID, scatter_impl="sorted_pallas")


def _preset_train(train_cls, preset, save_dir):
    """The preset's losses and metrics, with a save dir of the test's. The
    JAX Trainer's seed-4 weights predict both metric classes in validation
    after the two steps, so no comparison is of empty matrices."""
    t = preset.train
    return train_cls(num_epochs=1, class_weights=t.class_weights, seed=4,
                     metrics_num_classes=t.metrics_num_classes, save_dir=str(save_dir))


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """train/ (scene 001, 4 frames) and val/ (scene 002, 3 frames) packs."""
    pytest.importorskip("pandas")
    pytest.importorskip("PIL")
    tree = make_pandaset_tree(tmp_path_factory.mktemp("tree"), np.random.default_rng(21),
                              nan=False)
    root = tmp_path_factory.mktemp("packs")
    for split, scenes in (("train", SCENES[:1]), ("val", SCENES[1:])):
        write_pack(PandaSetDataset(tree, scenes, image_size=IMG, grid_size=GRID,
                                   max_points=NPTS), str(root / split))
    return str(root)


def test_presets_match_jax():
    j, p = jax_preset(), preset_pandaset_weighted()
    for f in ("num_classes", "fusion_type", "fusion_out_channels", "output_mode"):
        assert getattr(j.model, f) == getattr(p.model, f), f
    for f in ("num_epochs", "class_weights", "save_dir", "metrics_num_classes", "lr"):
        assert getattr(j.train, f) == getattr(p.train, f), f
    assert (p.data.dataset, p.model.num_classes, p.train.metrics_num_classes) == \
        ("pandaset", 3, 2)
    assert dataclasses.asdict(p.data) == dataclasses.asdict(j.data)


def _port_config(pack, save_dir):
    preset = preset_pandaset_weighted()
    return ExperimentConfig(
        model=ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                          lidar=LidarEncoderConfig(**LIDAR), **MODEL),
        data=DataConfig(dataset="packed", root=pack, image_size=IMG, grid_size=GRID,
                        max_points=NPTS, batch_size=BATCH, num_workers=0),
        train=_preset_train(TrainConfig, preset, save_dir))


def _jax_config(pack, save_dir):
    return JExp(model=JModel(camera=JCam(base_channels=4), lidar=JLidar(**LIDAR), **MODEL),
                data=JData(dataset="packed", root=pack, image_size=IMG, grid_size=GRID,
                           max_points=NPTS, batch_size=BATCH),
                train=_preset_train(JTrain, jax_preset(), save_dir),
                mesh=JMesh(num_devices=1))


@pytest.fixture(scope="module")
def runs(pack, tmp_path_factory):
    """The port's two steps and validation from the JAX Trainer's own
    seeded initial weights (its init_model, jitted), then the JAX Trainer's
    on the same batches, and again from those weights moved by 1e-6 of
    themselves."""
    cfg = _port_config(pack, tmp_path_factory.mktemp("port"))
    train_loader, val_loader = build_loaders(cfg, verbose=False)
    batches = list(train_loader)
    val_batches = list(val_loader)
    assert len(batches) == 2 and not batches[0]["point_valid"].all()

    jcfg = _jax_config(pack, tmp_path_factory.mktemp("jax"))
    real_init = jax_trainer_module.init_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "init_model", lambda model, rng, **kw: jax.jit(
            lambda r: real_init(model, r, **kw))(rng))
        jtr = jax_trainer_module.Trainer(jcfg, batches, val_batches)
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    init = get(jtr.state)

    tr = Trainer(cfg, train_loader, val_loader, device="cpu")
    tr.model.load_state_dict(from_jax_variables(
        {"params": init.params, "batch_stats": init.batch_stats}, cfg.model))
    port = {"loss": [], "cm": [], "grads": []}
    for b in batches:
        loss, cm = tr.train_step(b)
        port["loss"].append(float(loss))
        port["cm"].append(cm.numpy())
        port["grads"].append({k: p.grad.clone() for k, p in tr.params.items()})
    port["val_loss"], port["val"] = tr.validate()

    grad = jax.jit(jax.grad(lambda params, stats, batch: jtr._loss_and_metrics(
        params, stats, batch, train=True)[0]))

    def two_steps(state):
        out = {"loss": [], "cm": [], "grads": []}
        with jax.default_matmul_precision("highest"):
            for b in batches:
                out["grads"].append(get(grad(state.params, state.batch_stats, b)))
                new, loss, cm = jtr.train_step(jax.device_put(state), b)
                state = get(new)
                out["loss"].append(float(loss))
                out["cm"].append(np.asarray(cm))
            jtr.state = jax.device_put(state)
            out["val_loss"], out["val"] = jtr.validate()
        return out

    ref = two_steps(init)
    noise = np.random.default_rng(3)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
        init.params)
    return cfg, port, ref, two_steps(init.replace(params=moved)), init


def test_two_steps_and_validation_match_jax_trainer(runs):
    cfg, port, ref, pert, init = runs
    assert np.isfinite(port["loss"] + ref["loss"] + [port["val_loss"]]).all()
    for i in range(2):
        np.testing.assert_allclose(port["loss"][i], ref["loss"][i], atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(port["cm"][i], ref["cm"][i])
        assert port["cm"][i].sum() < BATCH * GRID[0] * GRID[1]  # class-2 pixels left out
        want_g = from_jax_variables({"params": ref["grads"][i], "batch_stats": init.batch_stats},
                                    cfg.model)
        moved_g = from_jax_variables({"params": pert["grads"][i],
                                      "batch_stats": init.batch_stats}, cfg.model)
        for k, g in port["grads"][i].items():
            name = k[len("model."):]
            g, w = g.numpy(), want_g[name].numpy()
            n = np.abs(moved_g[name].numpy() - w)
            spread = max(min(10 * n.max(), 0.1 * np.abs(w).max()), n.max())
            err = np.abs(g - w)
            assert (err <= 5e-3 + 1e-4 * np.abs(w) + spread).all(), \
                (i, k, float(err.max()), float(n.max()))
    np.testing.assert_allclose(port["val_loss"], ref["val_loss"], atol=1e-4, rtol=1e-5)
    assert port["val"]["miou"] == ref["val"]["miou"] and min(port["val"]["class_iou"]) > 0
    assert port["val"]["class_iou"] == list(ref["val"]["class_iou"])
    assert [iou_from_confusion(c)["miou"] for c in port["cm"]] == \
        [iou_from_confusion(c)["miou"] for c in ref["cm"]]
