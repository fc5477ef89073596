"""The data-parallel KD step against the JAX package, on the CPU: two gloo
ranks of one sample each against JAX's trajectory over the batch of two
(tests/test_torch_kd_step.py::_jax_trajectory: the sorted scatter in
interpret mode, the fused gate, kd_total_loss_fused; once with
fused_train), three steps held to that file's protocol
(`hold_kd_steps`: a fixed margin plus 10x the reference's spread under a
1e-6 weight perturbation, for the losses, the first-step gradients, the
three-step updates and the BN statistics). Each rank runs hold_kd_steps
with a trainer on the two-rank mesh that takes its row of the batch and
reports the global loss; the gradients it holds are the all-reduced ones.
After the steps, parameters and BN buffers are equal on both ranks bit for
bit.

The fsdp teacher (parallel/tp.py): its shard rule against JAX's
fsdp_shardings on the same tiny teacher (each leaf's sharded dim size and
bytes a rank), the bytes a rank about halved, its outputs equal to the
replicated teacher's bit for bit, and three KD steps with it equal to three
with the replicated teacher bit for bit.
"""

import collections
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_parallel import digest, rank_args, run_rank_script

torch.set_num_threads(2)

RUNS = {"plain": False, "fused_train": True}


@pytest.fixture(scope="module")
def kd_ranks(tmp_path_factory):
    """Both ranks: each reads one of the JAX trajectories (rank r the r-th
    of RUNS; test_torch_kd_step.py::jax_trajectory_cached, made by the
    first caller of this test run, so a rank may make it), then both run
    the port's steps against both."""
    import test_torch_kd_step as k
    out, cache = tmp_path_factory.mktemp("kd"), k.shared_dir(tmp_path_factory)
    ranks, _ = run_rank_script(__file__, len(RUNS), out, "--cache", str(cache))
    runs = {name: k.jax_trajectory_cached(cache, "sorted_pallas", fused_train=fused)
            for name, fused in RUNS.items()}
    return runs, ranks


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_hold_the_jax_trajectory(kd_ranks, run):
    """hold_kd_steps passed on both ranks (its message, if not, is shown)."""
    _, ranks = kd_ranks
    for r, res in enumerate(ranks):
        assert res[run]["held"] == "ok", f"rank {r}: {res[run]['held']}"
        assert res[run]["collectives"] > 0


@pytest.mark.parametrize("run", list(RUNS))
def test_ranks_end_with_equal_parameters(kd_ranks, run):
    _, (a, b) = kd_ranks
    for key in ("params", "buffers", "proj"):
        assert a[run][key] == b[run][key], key


def test_fsdp_shard_rule_matches_jax(kd_ranks):
    """Per leaf, the size of the sharded dim and the bytes a rank equal
    JAX's _fsdp_leaf_spec's over 2 devices (as multisets of the dims' sizes:
    the torch and flax layouts order a leaf's dims differently, and torch's
    Conv1d keeps a dim of 1 that flax's Dense has not)."""
    import jax
    from jax.sharding import Mesh

    from lmsu_tpu.parallel.tp import fsdp_shardings as jax_fsdp
    from lmsu_tpu_torch.config import teacher_config
    from lmsu_tpu_torch.models import create_model
    from lmsu_tpu_torch.parallel.tp import fsdp_shardings
    from test_torch_kd_step import _port_config
    runs, _ = kd_ranks
    t_vars = runs["plain"]["t_vars"]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    specs = jax_fsdp(t_vars, mesh)

    def jax_leaf(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        d = next((i for i, a in enumerate(spec) if a is not None), None)
        size = None if d is None else leaf.shape[d]
        return _dims(leaf.shape), size, leaf.size // (2 if d is not None else 1)
    want = collections.Counter(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        jax_leaf, t_vars, specs), is_leaf=lambda x: isinstance(x, tuple)))
    cfg = _port_config("sorted_pallas", "unused")
    teacher = create_model(teacher_config(cfg.model, 2.0))
    rule = fsdp_shardings(teacher, world_size=2)
    sd = teacher.state_dict()
    got = collections.Counter(
        (_dims(sd[k].shape), None if d is None else sd[k].shape[d],
         sd[k].numel() // (2 if d is not None else 1))
        for k, d in rule.items() if sd[k].dim() > 0)
    assert got == want
    assert all(d is None for d in fsdp_shardings(teacher, world_size=1).values())


def _dims(shape):
    return tuple(sorted(s for s in shape if s != 1))


def test_fsdp_teacher_equals_the_replicated_one(kd_ranks):
    _, ranks = kd_ranks
    for res in ranks:
        f = res["fsdp"]
        assert f["outputs_equal"] and f["steps_equal"], f
        assert f["bytes_per_rank"] <= 0.55 * f["bytes_full"], f
        assert f["gathers"] > 0


# -- the ranks -----------------------------------------------------------------


def _rank(rank, world, init, out: Path, cache: Path):
    import conftest  # noqa: F401 (JAX on the CPU, as in the test process)
    import test_torch_kd_step as k

    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.training import DistillationTrainer
    from lmsu_tpu_torch.utils.weights import from_jax_projections, from_jax_variables
    torch.set_num_threads(1)
    mesh = pm.make_mesh(device="cpu", init_method=init, rank=rank, world_size=world,
                        timeout_s=120)

    def rows(v):
        L = v.shape[0] // world
        return v[rank * L:(rank + 1) * L]

    class RankTrainer(DistillationTrainer):
        """This rank's row of every batch; the step returns the global loss."""

        def __init__(self, cfg, train_loader, val_loader, **kw):
            kw["device"] = "cpu"
            super().__init__(cfg, train_loader, val_loader, mesh=mesh, **kw)

        def train_step(self, batch, teacher_out=None):
            if teacher_out is not None:
                teacher_out = (rows(teacher_out[0]), {t: rows(v) for t, v in
                                                      teacher_out[1].items()})
            loss, cm = super().train_step({k_: rows(v) for k_, v in batch.items()},
                                          teacher_out=teacher_out)
            return pm.all_reduce_(loss.clone()), cm

    # Rank r asks first for the r-th trajectory: where none is made yet,
    # the ranks make the two at once.
    order = list(RUNS)[rank:] + list(RUNS)[:rank]
    runs = {n: k.jax_trajectory_cached(cache, "sorted_pallas", fused_train=RUNS[n])
            for n in order}
    k.DistillationTrainer = RankTrainer
    res = {}
    for name, fused in RUNS.items():
        mesh.reset_counts()
        try:
            tr = k.hold_kd_steps(runs[name], out / f"save{rank}", "in_loop", "sorted_pallas",
                                 fused_train=fused)
            held = "ok"
        except AssertionError as e:
            tr, held = None, f"AssertionError: {e}"
        res[name] = {"held": held, "collectives": mesh.counts["calls"]}
        if tr is not None:
            res[name].update(
                params=digest(tr.model.parameters()), proj=digest(tr.proj.values()),
                buffers=digest(v for k_, v in tr.model.state_dict().items()
                               if "running" in k_))

    # fsdp against the replicated teacher, from the same weights.
    run = runs["plain"]
    images, pts, labels = k._batch()
    batch = {"image": images, "points": pts, "segmentation": labels}
    local = {k_: rows(v) for k_, v in batch.items()}
    trs = {}
    for part in ("tp", "fsdp"):
        cfg = k._port_config("sorted_pallas", out / f"fsdp{rank}")
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, kd=dataclasses.replace(
            cfg.train.kd, teacher_partition=part)))
        tr = DistillationTrainer(cfg, [local], [local], device="cpu", mesh=mesh,
                                 teacher_state_dict=from_jax_variables(
                                     run["t_vars"], _teacher_cfg(cfg)))
        tr.model.load_state_dict(from_jax_variables(run["s_vars"], cfg.model))
        with torch.no_grad():
            for tap, p in from_jax_projections(run["proj"]).items():
                tr.proj[tap].copy_(p)
        trs[part] = tr
    outs = {p: trs[p].teacher_forward(batch) for p in trs}
    equal = torch.equal(outs["tp"][0], outs["fsdp"][0]) and all(
        torch.equal(outs["tp"][1][t], outs["fsdp"][1][t]) for t in outs["tp"][1])
    losses = {p: [float(tr.train_step(local)[0]) for _ in range(3)] for p, tr in trs.items()}
    steps_equal = losses["tp"] == losses["fsdp"] and digest(
        trs["tp"].params.values()) == digest(trs["fsdp"].params.values())
    sh = trs["fsdp"].teacher_shards
    res["fsdp"] = {"outputs_equal": bool(equal), "steps_equal": bool(steps_equal),
                   "bytes_per_rank": sh.bytes_per_rank, "bytes_full": sh.bytes_full,
                   "gathers": sh.gathers}
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    pm.destroy()


def _teacher_cfg(cfg):
    from lmsu_tpu_torch.config import teacher_config
    return teacher_config(cfg.model, cfg.train.kd.teacher_width_mult)


if __name__ == "__main__":
    _r, _w, _i, _o, _rest = rank_args(sys.argv[1:])
    assert _rest[0] == "--cache", _rest
    _rank(_r, _w, _i, _o, Path(_rest[1]))
