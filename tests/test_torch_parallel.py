"""Data parallelism of the port on the CPU (parallel/mesh.py): the index
math and loader stripes against the JAX package's, the mesh at world size
1, the trainer's world-size-free augmentation draws, and train-mode
BatchNorm synced over two gloo ranks against tests/test_multichip.py's
case (one batch of 16 on one device: rtol 1e-5, atol 1e-6), with remat too.

Multi-rank checks start their ranks once per file (`run_rank_script`: one
process a rank, this file run as a script, file:// rendezvous in a
temporary directory, one thread each, a timeout); each rank writes JSON
that the tests read. tests/test_torch_parallel_kd.py, _ce.py and
_serving.py use the same helpers.
"""

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240.0

torch.set_num_threads(2)


# -- helpers shared by the parallel test files ---------------------------------


def run_rank_script(script: str, world: int, out: Path, *args: str, while_running=None):
    """Run `world` ranks of `script` (a test file run as __main__), joined
    through a file:// rendezvous in `out`, by parallel/mesh.py::run_ranks
    (`while_running()` meanwhile, in this process); each rank writes
    out/rank<r>.json. Returns (the ranks' JSON, while_running's result)."""
    from lmsu_tpu_torch.parallel.mesh import run_ranks
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = "file://" + str(out / f"rendezvous_{time.monotonic_ns()}")
    _, extra = run_ranks([[sys.executable, script, "--rank", str(r), "--world", str(world),
                           "--init", init, "--out", str(out), *args] for r in range(world)],
                         RANK_TIMEOUT, env=env, cwd=str(ROOT), while_running=while_running)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)], extra


def rank_args(argv):
    """(rank, world, init, out, the other arguments) of a rank started by
    run_rank_script."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--init")
    p.add_argument("--out")
    a, rest = p.parse_known_args(argv)
    return a.rank, a.world, a.init, Path(a.out), rest


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal bit for bit or not."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# -- the index math and the stripes ----------------------------------------------


def test_mesh_config_fields_match_jax():
    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu_torch.config import MeshConfig
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMesh())


def test_local_shard_slices_match_jax():
    """Rank r of n holds rows [r B/n, (r+1) B/n): JAX's local_shard_slices on
    its 8-device mesh, devices grouped into n processes, gives the same."""
    import jax
    from jax.sharding import Mesh

    from lmsu_tpu.parallel.mesh import data_sharding
    from lmsu_tpu.parallel.mesh import local_shard_slices as jax_slices
    from lmsu_tpu_torch.parallel.mesh import local_shard_slices
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    devs = list(mesh.devices.flat)
    for n in (2, 4, 8):
        per = 8 // n
        for r in range(n):
            pairs = jax_slices(data_sharding(mesh), (16, 3), devs[r * per:(r + 1) * per])
            want = slice(pairs[0][1].start or 0, pairs[-1][1].stop)
            (_, got), = local_shard_slices((16, 3), n, [r])
            assert (got.start, got.stop) == (want.start, want.stop)
    assert [s for _, s in local_shard_slices((8,), 2)] == [slice(0, 4), slice(4, 8)]
    with pytest.raises(ValueError, match="not divisible"):
        local_shard_slices((9,), 2)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_stripes_match_jax_batcher(num_shards):
    """Every stripe of two shuffled epochs of 13 samples in global batches
    of 8 (the last padded) equals JAX's Batcher row for row, sample_mask,
    sample_index and the padded labels included; the stripes concatenate to
    the one-shard batch."""
    from lmsu_tpu.data.pipeline import Batcher as JBatcher
    from lmsu_tpu.data.synthetic import SyntheticMultiModalDataset as JSynthetic
    from lmsu_tpu_torch.data import Batcher, SyntheticMultiModalDataset
    kw = dict(num_samples=13, seed=3, image_size=(16, 16), grid_size=(8, 8), max_points=32)
    whole = Batcher(SyntheticMultiModalDataset(**kw), 8, shuffle=True, seed=5)
    stripes = []
    for s in range(num_shards):
        jb = JBatcher(JSynthetic(**kw), 8, shuffle=True, seed=5, num_shards=num_shards,
                      shard_index=s)
        pb = Batcher(SyntheticMultiModalDataset(**kw), 8, shuffle=True, seed=5,
                     num_shards=num_shards, shard_index=s)
        assert len(pb) == len(jb) == 2
        got = []
        for epoch in (0, 1):
            jb.set_epoch(epoch)
            pb.set_epoch(epoch)
            for a, b in zip(list(jb), list(pb), strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert b[k].shape[0] == 8 // num_shards
                got.append(b)
        stripes.append(got)
    for epoch in (0, 1):
        whole.set_epoch(epoch)
        for i, b in enumerate(whole):
            for k in b:
                np.testing.assert_array_equal(
                    np.concatenate([st[epoch * 2 + i][k] for st in stripes]), b[k])


def test_batcher_refusals_match_jax():
    from lmsu_tpu.data.pipeline import Batcher as JBatcher
    from lmsu_tpu_torch.data import Batcher
    for kw, match in ((dict(num_shards=3), "not divisible"),
                      (dict(num_shards=2, shard_index=2), "out of range")):
        for cls in (JBatcher, Batcher):
            with pytest.raises(ValueError, match=match):
                cls([0] * 8, 8, **kw)


def _ce_config(tmp_path):
    """tests/test_torch_trainer.py's tiny model with the xla scatter (its
    batches below are not cell-sorted)."""
    from test_torch_trainer import _config
    cfg = _config(tmp_path)
    return cfg.replace(model=cfg.model.replace(lidar=dataclasses.replace(
        cfg.model.lidar, scatter_impl="xla")))


def _ce_batch(seed: int, B: int):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (B, 64, 64, 3), dtype=np.uint8),
            "points": rng.normal(0, 20, (B, 512, 4)).astype(np.float32),
            "segmentation": rng.integers(0, 2, (B, 16, 16))}


def test_world_one_mesh_is_the_identity(tmp_path):
    """Without a group (and in a world-1 gloo group) every collective is the
    identity and issues nothing; make_loader takes stripe (1, 0); a CE step
    of a Trainer on the world-1 gloo mesh equals the one-process trainer's
    bit for bit (parameters, buffers, loss, confusion matrix)."""
    from lmsu_tpu_torch.data import make_loader
    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.parallel.tp import shard_teacher_fsdp, tp_axis
    from lmsu_tpu_torch.training import Trainer
    m = pm.make_mesh(device="cpu")
    try:
        x = torch.arange(4.0)
        assert pm.all_reduce_sum(x) is x and pm.all_gather(x) is x
        assert pm.process_data_stripes() == (1, 0) and m.counts["calls"] == 0
        # The 1-D mesh has no model axis; fsdp over one rank keeps the teacher whole.
        assert tp_axis(m) is None and shard_teacher_fsdp(torch.nn.Linear(2, 2), m) is None
        loader = make_loader(list(range(8)), 4, shuffle=False)
        assert (loader.batcher.num_shards, loader.batcher.shard_index) == (1, 0)
    finally:
        pm.destroy()
    cfg = _ce_config(tmp_path)
    batch = _ce_batch(0, 2)
    ref = Trainer(cfg, [batch], [batch], device="cpu")
    want = ref.train_step(batch)
    m = pm.make_mesh(device="cpu", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        assert m.group is not None and m.world_size == 1
        tr = Trainer(cfg, [batch], [batch], device="cpu", mesh=m)
        got = tr.train_step(batch)
        assert m.counts["calls"] == 0
    finally:
        pm.destroy()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for (k, a), b in zip(tr.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_trainer_refuses_a_mesh_that_is_not_the_active_one(tmp_path):
    """BatchNorm, the fused blocks and the loaders reduce over the active
    mesh: a trainer on a two-rank mesh that is not active, or on one rank
    while a two-rank mesh is active (at build or at a later step), is
    refused before any collective."""
    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.training import Trainer
    cfg, batch = _ce_config(tmp_path), _ce_batch(0, 2)
    one, two = (pm.Mesh(MeshConfig(), 0, n, torch.device("cpu"), "gloo") for n in (1, 2))
    with pytest.raises(ValueError, match="must be the active one"):
        Trainer(cfg, [batch], [batch], device="cpu", mesh=two)
    tr = Trainer(cfg, [batch], [batch], device="cpu")
    with pm.using(two):
        with pytest.raises(ValueError, match="must be the active one"):
            Trainer(cfg, [batch], [batch], device="cpu", mesh=one)
        with pytest.raises(ValueError, match="must be the active one"):
            tr.train_step(batch)
    assert two.counts["calls"] == 0 and pm.active() is None


def test_augment_draws_do_not_depend_on_the_world_size(tmp_path):
    """Rank r of n draws for the global batch and keeps its rows: its
    augmented stripe equals those rows of the one-process augmentation."""
    from lmsu_tpu_torch.config import AugmentConfig
    from lmsu_tpu_torch.training import Trainer
    cfg = _ce_config(tmp_path)
    aug = AugmentConfig(enabled=True, hflip_prob=0.5, brightness=0.1, contrast=0.1,
                        image_noise_std=0.02, point_dropout=0.05)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, augment=aug))
    b = {k: torch.from_numpy(v) for k, v in _ce_batch(1, 4).items()}
    tr = Trainer(cfg, [b], [b], device="cpu")
    tr.step = 7
    whole = tr._augmented(b)
    for world in (2, 4):
        L = 4 // world
        for r in range(world):
            tr.world, tr.rank = world, r
            part = tr._augmented({k: v[r * L:(r + 1) * L] for k, v in b.items()})
            for k, v in whole.items():
                assert torch.equal(part[k], v[r * L:(r + 1) * L]), (world, r, k)


# -- BatchNorm synced over two ranks ---------------------------------------------


def _bn_case():
    """tests/test_multichip.py::test_batchnorm_stats_are_global_batch's batch,
    and a 1x1 conv + BN + ReLU6 on it with seeded weights."""
    from lmsu_tpu_torch.models.layers import ReLU6, conv_bn_act
    x = np.random.default_rng(3).normal(1.5, 2.0, (16, 8, 8, 4)).astype(np.float32)
    torch.manual_seed(0)
    seq = torch.nn.Sequential(*conv_bn_act(4, 4, kernel_size=1, act=ReLU6()))
    with torch.no_grad():
        seq[1].weight.uniform_(0.5, 1.5)
        seq[1].bias.uniform_(-0.5, 0.5)
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), seq


def _bn_step(seq, x, use_remat: bool):
    """Train forward (under remat when asked) and backward of sum(y * w):
    the stats, the input gradient and the parameter gradients."""
    from lmsu_tpu_torch.models.layers import apply_seq, remat
    seq.train()
    x = x.clone().requires_grad_(True)
    y = remat(lambda t: apply_seq(seq, t), x) if use_remat else apply_seq(seq, x)
    w = torch.linspace(-1, 1, y[0].numel()).reshape(y.shape[1:])
    (y * w).sum().backward()
    bn = seq[1]
    return {"mean": bn.running_mean.tolist(), "var": bn.running_var.tolist(),
            "steps": int(bn.num_batches_tracked), "dx": x.grad.tolist(),
            "grads": [p.grad.tolist() for p in seq.parameters()]}


def _bn_rank(rank, world, init, out):
    from lmsu_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    pm.make_mesh(device="cpu", init_method=init, rank=rank, world_size=world, timeout_s=60)
    x, _ = _bn_case()
    L = x.shape[0] // world
    res = {}
    for use_remat in (False, True):
        _, seq = _bn_case()
        r = _bn_step(seq, x[rank * L:(rank + 1) * L], use_remat)
        # The parameter gradients are this rank's share: the trainer sums them.
        r["grads"] = [pm.all_reduce_(torch.tensor(g)).tolist() for g in r["grads"]]
        res["remat" if use_remat else "plain"] = r
    # all_reduce_sum: the sum over ranks, and the cotangent summed back.
    x = torch.full((3,), rank + 1.0, requires_grad=True)
    y = pm.all_reduce_sum(x)
    (y * (rank + 1.0)).sum().backward()
    res["all_reduce_sum"] = {"y": y.tolist(), "grad": x.grad.tolist()}
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    pm.destroy()


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn")
    return run_rank_script(__file__, 2, out, "--job", "bn")[0]


def test_all_reduce_sum_sums_values_and_cotangents(bn_ranks):
    """Two ranks holding 1 and 2: both read 3; each rank's loss y * (r + 1)
    sends back the sum of the cotangents, 1 + 2, to each."""
    for r in bn_ranks:
        assert r["all_reduce_sum"] == {"y": [3.0] * 3, "grad": [3.0] * 3}


@pytest.mark.parametrize("mode", ["plain", "remat"])
def test_synced_batchnorm_equals_one_batch(bn_ranks, mode):
    """Two ranks of 8 rows: running statistics within rtol 1e-5, atol 1e-6 of
    one process over the 16 (and of flax's ConvBNAct on one device, the
    JAX package's reference), moved once (remat's re-run reduces again and
    leaves them alone); the input and parameter gradients within 1e-5 of
    each tensor's scale (the synced path reduces the fast variance, the
    one-process path F.batch_norm's: f32 rounding apart)."""
    import jax.numpy as jnp

    from lmsu_tpu.models.layers import ConvBNAct
    x, seq = _bn_case()
    want = _bn_step(seq, x, mode == "remat")
    L = x.shape[0] // 2
    for r, got in enumerate(bn_ranks):
        got = got[mode]
        assert got["steps"] == want["steps"] == 1
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        pairs = [(got["dx"], np.asarray(want["dx"])[r * L:(r + 1) * L])]
        for g, w in pairs + list(zip(got["grads"], want["grads"])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-6)
    _, seq = _bn_case()
    variables = {"params": {"conv": {"kernel": jnp.asarray(
        seq[0].weight.detach().permute(2, 3, 1, 0).numpy())},
        "bn": {"scale": jnp.asarray(seq[1].weight.detach().numpy()),
               "bias": jnp.asarray(seq[1].bias.detach().numpy())}},
        "batch_stats": {"bn": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}}
    _, mut = ConvBNAct(features=4, kernel_size=(1, 1)).apply(
        variables, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), train=True,
        mutable=["batch_stats"])
    for r in bn_ranks:
        np.testing.assert_allclose(r[mode]["mean"], np.asarray(mut["batch_stats"]["bn"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[mode]["var"], np.asarray(mut["batch_stats"]["bn"]["var"]),
                                   rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank, _world, _init, _out, _rest = rank_args(sys.argv[1:])
    if _rest == ["--job", "bn"]:
        _bn_rank(_rank, _world, _init, _out)
