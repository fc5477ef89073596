"""The data-parallel CE trainer against the JAX Trainer, on the CPU.

Two gloo ranks, each decoding its stripe of every global batch of 8
(Batcher num_shards=2) from 12 synthetic samples, so the second batch is 4
real samples and 4 padded ones (sample_mask, all-ignored labels), against
the JAX Trainer on its default 8-device CPU mesh (tests/conftest.py) over
the same global batches, from the same weights (the port's seeded weights
carried over with convert_torch_state_dict). Two train steps, then one
validation pass. Tolerances, those of tests/test_torch_pandaset_train.py
for a train-mode CE step: each step's global loss (the sum of the ranks'
shares) within atol 1e-4, rtol 1e-5; every all-reduced parameter gradient
of each step (JAX's: the gradient its train step applied, read back from
AdamW's first moment) within atol 5e-3, rtol 1e-4, plus 10x the
reference's own spread N (the same steps from weights moved by 1e-6 of
themselves), capped at 0.1 max|g| but never below N; the confusion
matrices of both steps (summed over ranks) and of validation equal
exactly; the validation loss within atol 1e-4, rtol 1e-5. Both ranks end
with the same parameters and BN buffers, bit for bit.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_parallel import digest, rank_args, run_rank_script

torch.set_num_threads(2)

N_TRAIN, N_VAL, BATCH, IMG, GRID, NPTS = 12, 8, 8, (32, 32), (8, 8), 64
MODEL = dict(num_classes=2, fusion_type="concat", fusion_out_channels=32, camera_fpn_channels=16)
LIDAR = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID, scatter_impl="xla")


def _port_config(save_dir):
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       LidarEncoderConfig, ModelConfig, TrainConfig)
    return ExperimentConfig(
        model=ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                          lidar=LidarEncoderConfig(**LIDAR), **MODEL),
        data=DataConfig(image_size=IMG, grid_size=GRID, max_points=NPTS, batch_size=BATCH),
        train=TrainConfig(num_epochs=1, class_weights=(0.4, 3.5), seed=5,
                          save_dir=str(save_dir)))


def _datasets():
    from lmsu_tpu_torch.data import SyntheticMultiModalDataset
    kw = dict(image_size=IMG, grid_size=GRID, max_points=NPTS)
    return (SyntheticMultiModalDataset(num_samples=N_TRAIN, seed=0, **kw),
            SyntheticMultiModalDataset(num_samples=N_VAL, seed=10_000, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks, and meanwhile the JAX Trainer's two steps and validation
    from the same weights, and again from those weights moved by 1e-6."""
    from lmsu_tpu.config import CameraEncoderConfig as JCam
    from lmsu_tpu.config import DataConfig as JData
    from lmsu_tpu.config import ExperimentConfig as JExp
    from lmsu_tpu.config import LidarEncoderConfig as JLidar
    from lmsu_tpu.config import ModelConfig as JModel
    from lmsu_tpu.config import TrainConfig as JTrain
    from lmsu_tpu.training import trainer as jax_trainer_module
    from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
    from lmsu_tpu_torch.data import Batcher
    from lmsu_tpu_torch.models import create_model
    out = tmp_path_factory.mktemp("ce")
    cfg = _port_config(out / "unused")

    def jax_steps():
        train_ds, val_ds = _datasets()
        batches = list(Batcher(train_ds, BATCH))
        val_batches = list(Batcher(val_ds, BATCH))
        assert len(batches) == 2 and batches[1]["sample_mask"].sum() == 4
        init_sd = create_model(cfg.model, seed=cfg.train.seed).state_dict()
        jcfg = JExp(model=JModel(camera=JCam(base_channels=4), lidar=JLidar(**LIDAR), **MODEL),
                    data=JData(image_size=IMG, grid_size=GRID, max_points=NPTS,
                               batch_size=BATCH),
                    train=JTrain(num_epochs=1, class_weights=(0.4, 3.5), seed=5,
                                 save_dir=str(out / "jax")))
        variables = convert_torch_state_dict(init_sd, jcfg.model)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer_module, "init_model", lambda model, rng, **kw: variables)
            jtr = jax_trainer_module.Trainer(jcfg, batches, val_batches)
        assert jtr.mesh.devices.size == 8
        get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
        init = get(jtr.state)
        def first_moment(state):
            """AdamW's first moment m (optax's ScaleByAdamState.mu)."""
            adam, = [s for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
            return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), adam.mu)

        def two_steps(state):
            # Each step's gradient read back from AdamW's first moment, m_t =
            # 0.1 g_t + 0.9 m_{t-1} (optax's b1; no clipping by default), so
            # JAX compiles only the Trainer's own steps, not a gradient too.
            res = {"loss": [], "cm": [], "grads": []}
            m = first_moment(state)
            with jax.default_matmul_precision("highest"):
                for b in batches:
                    new, loss, cm = jtr.train_step(jax.device_put(state), b)
                    state = get(new)
                    m, m_before = first_moment(state), m
                    res["grads"].append(jax.tree_util.tree_map(
                        lambda a, b_: ((a - 0.9 * b_) / 0.1).astype(np.float32), m, m_before))
                    res["loss"].append(float(loss))
                    res["cm"].append(np.asarray(cm))
                jtr.state = jax.device_put(state)
                res["val_loss"], res["val"] = jtr.validate()
            return res

        ref = two_steps(init)
        noise = np.random.default_rng(3)
        moved = jax.tree_util.tree_map(
            lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
            init.params)
        pert = two_steps(init.replace(params=moved))
        return ref, pert, init

    ranks, (ref, pert, init) = run_rank_script(__file__, 2, out, while_running=jax_steps)
    port = [dict(r, grads=[dict(np.load(out / f"grads{i}_step{s}.npz"))
                           for s in range(2)]) for i, r in enumerate(ranks)]
    return cfg, port, ref, pert, init


def test_two_steps_and_validation_match_jax_trainer(runs):
    from lmsu_tpu_torch.utils.weights import from_jax_variables
    cfg, port, ref, pert, init = runs
    # Rows [4r, 4r + 4) of each global batch; the padded batch repeats row 8.
    assert [r["decoded"] for r in port] == [[0, 1, 2, 3, 8, 9, 10, 11], [4, 5, 6, 7, 8, 8, 8, 8]]
    for rank in port:
        for i in range(2):
            np.testing.assert_allclose(rank["loss"][i], ref["loss"][i], atol=1e-4, rtol=1e-5)
            np.testing.assert_array_equal(rank["cm"][i], ref["cm"][i])
            want_g = from_jax_variables({"params": ref["grads"][i],
                                         "batch_stats": init.batch_stats}, cfg.model)
            moved_g = from_jax_variables({"params": pert["grads"][i],
                                          "batch_stats": init.batch_stats}, cfg.model)
            assert set(rank["grads"][i]) == {f"model.{k}" for k in want_g
                                             if not k.endswith(("running_mean", "running_var",
                                                                "num_batches_tracked"))}
            for k, g in rank["grads"][i].items():
                name = k[len("model."):]
                w = want_g[name].numpy()
                n = np.abs(moved_g[name].numpy() - w)
                spread = max(min(10 * n.max(), 0.1 * np.abs(w).max()), n.max())
                err = np.abs(g - w)
                assert (err <= 5e-3 + 1e-4 * np.abs(w) + spread).all(), \
                    (i, k, float(err.max()), float(n.max()))
        np.testing.assert_allclose(rank["val_loss"], ref["val_loss"], atol=1e-4, rtol=1e-5)
        assert rank["val_miou"] == ref["val"]["miou"]
        assert rank["val_class_iou"] == list(ref["val"]["class_iou"])


def test_ranks_end_with_equal_parameters(runs):
    _, (a, b), *_ = runs
    assert a["params"] == b["params"] and a["buffers"] == b["buffers"]


def _rank(rank, world, init, out: Path):
    from lmsu_tpu_torch.data import make_loader
    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.training import Trainer
    torch.set_num_threads(1)
    mesh = pm.make_mesh(device="cpu", init_method=init, rank=rank, world_size=world,
                        timeout_s=120)
    cfg = _port_config(out / f"save{rank}")
    train_ds, val_ds = _datasets()
    train_loader = make_loader(train_ds, BATCH, shuffle=False)
    val_loader = make_loader(val_ds, BATCH, shuffle=False)
    tr = Trainer(cfg, train_loader, val_loader, device="cpu", mesh=mesh)
    res = {"loss": [], "cm": [], "decoded": []}
    for s, batch in enumerate(train_loader):
        assert batch["image"].shape[0] == BATCH // world
        res["decoded"] += [int(i) for i in batch["sample_index"]]
        loss, cm = tr.train_step(batch)
        res["loss"].append(float(pm.all_reduce_(loss.clone())))
        res["cm"].append(pm.all_reduce_(cm.clone()).tolist())
        np.savez(out / f"grads{rank}_step{s}.npz",
                 **{k: p.grad.numpy() for k, p in tr.params.items()})
    res["val_loss"], val = tr.validate()
    res["val_miou"], res["val_class_iou"] = val["miou"], list(val["class_iou"])
    res["params"] = digest(tr.params.values())
    res["buffers"] = digest(tr.model.buffers())
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    pm.destroy()


if __name__ == "__main__":
    _r, _w, _i, _o, _ = rank_args(sys.argv[1:])
    _rank(_r, _w, _i, _o)
