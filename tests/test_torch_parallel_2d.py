"""The port's 2-D (data, model) mesh on the CPU (parallel/mesh.py): the
data-major rank layout and the loader stripes against the JAX package's
make_mesh and data sharding, JAX's refusal of a model_parallel that does
not divide the devices, and four gloo ranks on a (data 2, model 2) mesh:
each axis's groups and collectives, the loader's stripes (the ranks of one
model group decode the same one), a CE training epoch with EMA against
one process (a fixed margin plus 10x the one-process run's spread under a
1e-6 weight perturbation), with every reduction over the data axis only,
and the replicas equal bit for bit along the model axis; and
`run_multiprocess --device cpu --num-processes 2 --model-parallel 2`.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_parallel import ROOT, digest, rank_args, run_rank_script

torch.set_num_threads(2)

N_TRAIN, BATCH = 16, 8


def _mesh(rank, world, mp):
    """The Mesh object of `rank` (no process group: the index math only)."""
    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.parallel.mesh import Mesh
    return Mesh(MeshConfig(model_parallel=mp), rank, world, torch.device("cpu"), None,
                model_size=mp)


@pytest.mark.parametrize("world,mp", [(4, 2), (8, 4)])
def test_rank_layout_matches_jax(world, mp):
    """Rank r sits where device r sits in JAX's make_mesh grid (data-major
    reshape(n / M, M)): the model groups are its rows, the data groups its
    columns, and each rank's coordinates are (r // M, r % M)."""
    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu.parallel.mesh import make_mesh
    from lmsu_tpu_torch.parallel.mesh import mesh_layout
    import jax
    grid = np.vectorize(lambda d: d.id)(make_mesh(JMesh(model_parallel=mp),
                                                  jax.devices()[:world]).devices)
    layout = mesh_layout(world, mp)
    assert layout["model"] == grid.tolist()
    assert layout["data"] == grid.T.tolist()
    for r in range(world):
        m = _mesh(r, world, mp)
        assert (m.data_rank, m.model_rank, m.data_size) == tuple(np.argwhere(grid == r)[0]) + (
            world // mp,)


@pytest.mark.parametrize("world,mp", [(4, 2), (8, 4)])
def test_process_data_stripes_match_jax(world, mp):
    """process_data_stripes is (D, rank // M): the stripe of the rows JAX's
    data sharding gives device r on its 2-D mesh (one device a process, as
    JAX's process_data_stripes reads it when the model axis spans
    processes); the M ranks of one model group share it."""
    import jax

    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu.parallel.mesh import data_sharding, make_mesh
    from lmsu_tpu_torch.parallel.mesh import process_data_stripes
    D = world // mp
    jmesh = make_mesh(JMesh(model_parallel=mp), jax.devices()[:world])
    rows = data_sharding(jmesh).devices_indices_map((D,))
    for dev, idx in rows.items():
        assert process_data_stripes(_mesh(dev.id, world, mp)) == (D, idx[0].start or 0)


def test_indivisible_model_parallel_is_refused_in_jax_words():
    """model_parallel must divide the ranks: the port raises JAX make_mesh's
    ValueError, word for word."""
    import jax

    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu.parallel.mesh import make_mesh
    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.parallel.mesh import check_mesh_config
    with pytest.raises(ValueError) as want:
        make_mesh(JMesh(model_parallel=3), jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        check_mesh_config(MeshConfig(model_parallel=3), 8)
    assert str(got.value) == str(want.value)
    check_mesh_config(MeshConfig(model_parallel=4), 8)


def test_loader_stripes_follow_the_model_groups():
    """make_loader's default stripe under an active 2-D mesh: the ranks of
    one model group decode the same samples, the data groups' stripes are
    disjoint and cover the set."""
    from lmsu_tpu_torch.data import SyntheticMultiModalDataset, make_loader
    from lmsu_tpu_torch.parallel import mesh as pm
    ds = SyntheticMultiModalDataset(num_samples=N_TRAIN, image_size=(32, 32), grid_size=(8, 8),
                                    max_points=16)
    seen = {}
    for r in range(4):
        with pm.using(_mesh(r, 4, 2)):
            loader = make_loader(ds, BATCH, shuffle=False)
        seen[r] = [int(i) for b in loader.batcher for i in b["sample_index"]]
    assert seen[0] == seen[1] and seen[2] == seen[3]
    assert sorted(seen[0] + seen[2]) == list(range(N_TRAIN))


# -- four ranks ----------------------------------------------------------------


def _run_multiprocess():
    """`run_multiprocess --device cpu --num-processes 2 --model-parallel 2`
    (while the ranks run): exit code and the summary."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "lmsu_tpu_torch.run_multiprocess", "--device",
                           "cpu", "--num-processes", "2", "--model-parallel", "2",
                           "--timeout", "200"], cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=240)
    text = proc.stdout
    summary = (json.loads(text[text.index("{", text.index("OK")):])
               if proc.returncode == 0 and "OK" in text else None)
    return proc.returncode, summary, (text + proc.stderr)[-3000:]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2d")
    return run_rank_script(__file__, 4, out, while_running=_run_multiprocess)


def test_axis_groups_and_collectives(ranks):
    """Each rank's axes: the data group (same m) and the model group (same
    d) with its coordinates; a sum over each axis, a gather over the model
    axis in model order, a broadcast from model coordinate 0."""
    res, _ = ranks
    for r, rr in enumerate(res):
        d, m = divmod(r, 2)
        assert rr["data"] == {"rank": d, "size": 2, "ranks": [m, 2 + m]}
        assert rr["model"] == {"rank": m, "size": 2, "ranks": [2 * d, 2 * d + 1]}
        assert rr["sum_data"] == (m + 1) + (2 + m + 1)
        assert rr["sum_model"] == (2 * d + 1) + (2 * d + 2)
        assert rr["gather_model"] == [2 * d, 2 * d + 1]
        assert rr["broadcast_model"] == 2 * d
        assert rr["stripes"] == [2, d]


def test_ce_epoch_matches_one_process(ranks):
    """A CE epoch and validation with EMA on the 2x2 mesh (each model
    group its data stripe) against one process over the whole set: train
    and val loss within 1e-6 of them plus 10x the one-process run's spread
    under a 1e-6 weight perturbation, mIoU likewise. A reduction over the
    whole world would count each stripe twice."""
    res, _ = ranks
    for r, rr in enumerate(res):
        for q, (err, spread, scale) in rr["held"].items():
            assert err <= 1e-6 * max(scale, 1.0) + 10 * spread, (r, q, err, spread, scale)


def test_model_groups_decode_the_same_stripe(ranks):
    res, _ = ranks
    assert res[0]["decoded"] == res[1]["decoded"] and res[2]["decoded"] == res[3]["decoded"]
    assert sorted(res[0]["decoded"] + res[2]["decoded"]) == list(range(N_TRAIN))


def test_replicas_bit_equal_along_the_model_axis(ranks):
    """Parameters, BN buffers and EMA equal bit for bit on all four ranks,
    and the step issued one model-axis broadcast a step (the gradients and
    buffers of model coordinate 0)."""
    res, _ = ranks
    assert len({rr["digest"] for rr in res}) == 1
    for rr in res:
        assert rr["model_calls_per_step"] == 1


def test_run_multiprocess_model_parallel(ranks):
    """run_multiprocess with a model axis of two processes: exit 0, the tp
    teacher split, the model axis across processes, one stripe."""
    _, (rc, summary, tail) = ranks
    assert rc == 0, tail
    assert summary["model_parallel"] == 2 and summary["model_axis_spans_processes"]
    assert summary["teacher_layout"] == "tp" and summary["num_stripes"] == 1
    assert summary["teacher_bytes_per_rank"] < summary["teacher_bytes_full"]


# -- the ranks -----------------------------------------------------------------


def _config(save_dir, mp):
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       LidarEncoderConfig, MeshConfig, ModelConfig, TrainConfig)
    return ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="concat", fusion_out_channels=32,
                          camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),
                          lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                   grid_size=(8, 8))),
        data=DataConfig(dataset="synthetic", image_size=(32, 32), grid_size=(8, 8),
                        max_points=64, batch_size=BATCH),
        train=TrainConfig(num_epochs=1, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                          ema_decay=0.9),
        mesh=MeshConfig(model_parallel=mp))


def _epoch(cfg, perturb=0.0, mesh=None):
    """(train loss, train mIoU, val loss, val mIoU, trainer) of one epoch."""
    from lmsu_tpu_torch.data import SyntheticMultiModalDataset, make_loader
    from lmsu_tpu_torch.training import Trainer
    kw = dict(image_size=(32, 32), grid_size=(8, 8), max_points=64)
    train = make_loader(SyntheticMultiModalDataset(num_samples=N_TRAIN, **kw), BATCH,
                        shuffle=False)
    val = make_loader(SyntheticMultiModalDataset(num_samples=BATCH, seed=10_000, **kw), BATCH,
                      shuffle=False)
    tr = Trainer(cfg, train, val, device="cpu", mesh=mesh)
    if perturb:
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for k, p in tr.params.items():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
                tr.ema_params[k].copy_(p)
    loss, m = tr.train_epoch()
    vloss, vm = tr.validate()
    return (loss, m["miou"], vloss, vm["miou"]), tr


def _rank(rank, world, init, out: Path):
    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    mesh = pm.make_mesh(MeshConfig(model_parallel=2), device="cpu", init_method=init,
                        rank=rank, world_size=world, timeout_s=120)
    dm, mm = mesh.data_axis(), mesh.model_axis()
    res = {"data": {"rank": dm.rank, "size": dm.world_size, "ranks": list(dm.ranks)},
           "model": {"rank": mm.rank, "size": mm.world_size, "ranks": list(mm.ranks)},
           "stripes": list(pm.process_data_stripes())}
    one = torch.tensor([float(rank + 1)])
    res["sum_data"] = float(pm.all_reduce_(one.clone(), mesh=dm))
    res["sum_model"] = float(pm.all_reduce_(one.clone(), mesh=mm))
    res["gather_model"] = pm.all_gather(torch.tensor([rank]), mm).tolist()
    b = torch.tensor([rank])
    pm.broadcast_([b], 0, mm)
    res["broadcast_model"] = int(b)

    with pm.using(None):
        ref, _ = _epoch(_config(out / f"one{rank}", 1))
        pert, _ = _epoch(_config(out / f"pert{rank}", 1), perturb=1e-6)
    mesh.reset_counts()
    got, tr = _epoch(_config(out / f"mesh{rank}", 2), mesh=mesh)
    names = ("train_loss", "train_miou", "val_loss", "val_miou")
    res["held"] = {n: (abs(got[i] - ref[i]), abs(pert[i] - ref[i]), abs(ref[i]))
                   for i, n in enumerate(names)}
    res["model_calls_per_step"] = mesh.model_axis().counts["calls"] / tr.steps_per_epoch
    res["decoded"] = [int(i) for bt in tr.train_loader.batcher for i in bt["sample_index"]]
    res["digest"] = digest(list(tr.params.values()) + list(tr.model.buffers())
                           + list(tr.ema_params.values()))
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    pm.destroy()


if __name__ == "__main__":
    _r, _w, _i, _o, _ = rank_args(sys.argv[1:])
    _rank(_r, _w, _i, _o)
