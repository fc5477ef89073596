"""The model axis of the port's teacher (parallel/tp.py) on the CPU: the
tp rule against the JAX package's tp_shardings, and four gloo ranks on a
(data 2, model 2) mesh against JAX's 4x2 mesh of tests/test_tp.py.

Each rank builds the same seeded teachers (the tiny configuration of
tests/test_tp.py:30-41 and variants: the weighted fusion with its fused
gate and the x4 head, the concat teacher with fused_inference blocks, and
one whose LiDAR MLP has a width that two ranks do not divide) and runs
them split by channel (tp) and by image rows (sp) on its data stripe. The
JAX side runs in this process while the ranks do: the same weights
(carried by convert_torch_state_dict) under shard_variables_tp and under
the sp with_sharding_constraint on the 4x2 mesh, held to the ranks'
outputs at tests/test_tp.py's 1e-5 (the JAX gate without its Pallas
kernel: the port's fused gate takes its plain version on the CPU). The
1e-5 is of each tensor's scale, max(1, max |x|): the two packages' f32
convolutions round differently, and the port's WHOLE teacher is already
3.8e-5 from JAX's on the LiDAR tap, whose scale is 93 (3e-7 of it), where
its split and whole teachers agree. The
ranks also hold a two-member ensemble under tp and the fsdp teacher of the
2-D mesh (split over the data axis only) to the port's one-process
teacher, and run two KD steps each with tp and sp (tests/test_tp.py's KD
configuration) held to the port's one-process step, whose own steps
tests/test_torch_kd_step.py holds to JAX: a fixed margin plus 10x the
step's own spread under a 1e-6 weight perturbation. The replicas along
the model axis end bit-equal.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_parallel import digest, rank_args, run_rank_script

torch.set_num_threads(2)

B = 8          # the global batch
IMG = 32
NPTS = 64
ATOL = 1e-5    # tests/test_tp.py's, of a tensor's scale (module docstring)


def scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def port_config(variant: str):
    """The port's ModelConfig of a teacher variant (tests/test_tp.py:30-41's
    tiny configuration and its changes)."""
    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    fusion = "weighted" if variant == "weighted" else "concat"
    return ModelConfig(
        num_classes=2, fusion_type=fusion, fusion_out_channels=32, camera_fpn_channels=16,
        output_mode="x4" if variant == "weighted" else "same",
        use_pallas_fusion=variant == "weighted",
        camera=CameraEncoderConfig(base_channels=8, fused_inference=variant == "fused"),
        lidar=LidarEncoderConfig(feature_dim=16,
                                 mlp_dims=(9, 16) if variant == "indivisible" else (8, 16),
                                 grid_size=(8, 8)))


VARIANTS = ("concat", "weighted", "fused", "indivisible")
JAX_VARIANTS = ("concat", "weighted")


def tiny_teacher(variant: str):
    """A frozen teacher of `variant` with every leaf drawn from one seed
    (BN means N(0, 0.2), variances U(0.5, 2), affine and biases moved, the
    transposed convs drawn too), the same in every process."""
    from lmsu_tpu_torch.models import create_model
    model = create_model(port_config(variant), seed=0)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                t.copy_(0.5 + 1.5 * torch.rand(t.shape, generator=g))
            elif name.endswith(("bias", "weight")) and t.dim() == 1:
                t.add_(torch.randn(t.shape, generator=g) * 0.2)
            elif "up" in name and t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
    return model.eval().requires_grad_(False)


def tiny_batch():
    r = np.random.default_rng(3)
    img = r.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)
    pts = r.normal(0, 30, (B, NPTS, 4)).astype(np.float32)
    pts[..., 2] = r.uniform(-5, 3, (B, NPTS))
    return img, pts


def outputs(out) -> dict:
    """Logits and taps as NHWC float64 numpy."""
    logits, taps = out
    res = {"logits": logits.double().numpy()}
    res.update({k: v.permute(0, 2, 3, 1).double().numpy() for k, v in taps.items()
                if k != "logits"})
    return res


def kd_config(part: str, save_dir: str, ensemble: int = 1, mp: int = 2, image: int = IMG):
    """tests/test_tp.py::_kd_config in the port (B=8, base_channels 4), on
    a mesh of model_parallel `mp`, at `image` x `image`."""
    from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                       KDConfig, LidarEncoderConfig, MeshConfig, ModelConfig,
                                       TrainConfig)
    return ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="concat", fusion_out_channels=32,
                          camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),
                          lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                   grid_size=(8, 8))),
        data=DataConfig(dataset="synthetic", synthetic_num_train=B, synthetic_num_val=B,
                        image_size=(image, image), grid_size=(8, 8), max_points=NPTS,
                        batch_size=B),
        train=TrainConfig(num_epochs=1, class_weights=(0.4, 3.5), save_dir=save_dir,
                          ema_decay=0.9,
                          kd=KDConfig(enabled=True, teacher_partition=part,
                                      ensemble_size=ensemble,
                                      feature_taps=("camera_feat", "post_fusion"))),
        mesh=MeshConfig(model_parallel=mp))


def kd_batch():
    r = np.random.default_rng(11)
    img, pts = tiny_batch()
    return {"image": (img * 255).astype(np.uint8), "points": pts,
            "segmentation": r.integers(0, 2, (B, 8, 8)).astype(np.int64)}


# -- the rule, against JAX's ----------------------------------------------------


@pytest.mark.parametrize("variant", JAX_VARIANTS)
def test_tp_shardings_match_jax_leaf_for_leaf(variant):
    """tp_shardings on the port's teacher against JAX tp_shardings on the
    same weights over the 4x2 mesh, leaf for leaf through the weight
    converters: each JAX leaf is marked by the index along its split dim
    (0 where whole), carried to the port's names and layouts by
    utils/weights.py::from_jax_variables; the port's leaf must vary along
    exactly the dim its rule splits, and be 0 where the rule keeps it
    whole."""
    import jax
    from jax.sharding import PartitionSpec as P

    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu.parallel.mesh import make_mesh
    from lmsu_tpu.parallel.tp import tp_shardings as jax_tp
    from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
    from lmsu_tpu_torch.parallel.tp import tp_shardings
    from lmsu_tpu_torch.utils.weights import from_jax_variables
    teacher = tiny_teacher(variant)
    jcfg = jax_config(variant)
    v = convert_torch_state_dict(teacher.state_dict(), jcfg)
    specs = jax_tp(v, make_mesh(JMesh(model_parallel=2)))

    def mark(leaf, sh):
        leaf = np.asarray(leaf)
        if sh.spec == P():
            return np.zeros_like(leaf)
        assert tuple(sh.spec) == (None,) * (leaf.ndim - 1) + ("model",), sh.spec
        return np.broadcast_to(1.0 + np.arange(leaf.shape[-1], dtype=np.float32),
                               leaf.shape).copy()
    marked = from_jax_variables(jax.tree_util.tree_map(mark, v, specs), port_config(variant))
    rule = tp_shardings(teacher, 2)
    assert set(marked) <= set(rule)
    split = 0
    for k, t in marked.items():
        d = rule[k]
        if d is None:
            assert not t.any(), k
            continue
        split += 1
        moved = t.movedim(d, 0).reshape(t.shape[d], -1)
        assert torch.equal(moved[:, 0], torch.arange(1, t.shape[d] + 1, dtype=t.dtype)), k
        assert (moved == moved[:, :1]).all(), k
    assert split > 0
    assert rule["head.cls.weight"] is None and rule["head.cls.bias"] is None


def test_sp_height_is_refused_by_name(ranks):
    """sp needs H / M rows a rank to be a multiple of the encoder's total
    stride 8: 32 rows over 2 (16) and over 4 (8) pass; 40 over 2 (20) and
    24 over 2 (12) are refused by name, by the trainer on the 2x2 mesh too
    (40 x 40 images)."""
    from lmsu_tpu_torch.parallel.tp import check_sp_height
    check_sp_height(32, 2)
    check_sp_height(32, 4)
    for h in (40, 24):
        with pytest.raises(ValueError, match="not a multiple of the camera encoder's total "
                           "stride 8"):
            check_sp_height(h, 2)
    res, _, _ = ranks
    assert all("total stride 8" in rr["sp_height_refusal"] for rr in res), res[0]


def test_tp_dim_rule():
    """dim 0 where the axis divides it; whole for the classifier, scalars
    and an indivisible dim 0; everything whole at one rank."""
    from lmsu_tpu_torch.parallel.tp import tp_dim
    assert tp_dim("fusion.fuse.0.weight", (48, 1, 3, 3), 2) == 0
    assert tp_dim("head.up1.0.weight", (32, 64, 4, 4), 2) == 0   # a transposed conv's Cin
    assert tp_dim("head.cls.weight", (2, 32, 1, 1), 2) is None
    assert tp_dim("head.cls.bias", (2,), 2) is None
    assert tp_dim("fusion.attention.2.weight", (2, 32, 1, 1), 2) == 0
    assert tp_dim("x.num_batches_tracked", (), 2) is None
    assert tp_dim("lidar_encoder.encoder.point_mlp.0.weight", (9, 4, 1), 2) is None
    assert tp_dim("fusion.fuse.0.weight", (48, 1, 3, 3), 1) is None


# -- four ranks ----------------------------------------------------------------


def jax_config(variant: str):
    """The JAX package's ModelConfig of port_config(variant); the weighted
    gate without its Pallas kernel."""
    from lmsu_tpu.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    p = port_config(variant)
    return ModelConfig(
        num_classes=2, fusion_type=p.fusion_type, fusion_out_channels=32,
        camera_fpn_channels=16, output_mode=p.output_mode, use_pallas_fusion=False,
        camera=CameraEncoderConfig(base_channels=8),
        lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=tuple(p.lidar.mlp_dims),
                                 grid_size=(8, 8)))


def jax_outputs():
    """{(variant, part): NHWC outputs over the global batch} of JAX's tp and
    sp teacher on the 4x2 mesh (tests/test_tp.py's two forwards)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lmsu_tpu.config import MeshConfig as JMesh
    from lmsu_tpu.models import create_model
    from lmsu_tpu.parallel.mesh import data_sharding, make_mesh, replicated_sharding
    from lmsu_tpu.parallel.tp import shard_variables_tp, tp_shardings
    from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
    mesh = make_mesh(JMesh(model_parallel=2))
    dsh = data_sharding(mesh)
    img, pts = tiny_batch()
    img, pts = jax.device_put(jnp.asarray(img), dsh), jax.device_put(jnp.asarray(pts), dsh)
    out = {}
    for variant in JAX_VARIANTS:
        jcfg = jax_config(variant)
        model = create_model(jcfg)
        v = convert_torch_state_dict(tiny_teacher(variant).state_dict(), jcfg)
        sp = NamedSharding(mesh, P("data", "model"))

        def fwd(v, i, p, constrain=False):
            if constrain:
                i = jax.lax.with_sharding_constraint(i, sp)
            return model.apply(v, i, p, train=False, return_intermediates=True)
        with jax.default_matmul_precision("highest"):
            runs = {"tp": jax.jit(fwd, in_shardings=(tp_shardings(v, mesh), dsh, dsh))(
                        shard_variables_tp(v, mesh), img, pts),
                    "sp": jax.jit(lambda v, i, p: fwd(v, i, p, True),
                                  in_shardings=(replicated_sharding(mesh), dsh, dsh))(
                        v, img, pts)}
        for part, (logits, feats) in runs.items():
            res = {"logits": np.asarray(logits, np.float64)}
            res.update({k: np.asarray(feats[k], np.float64)
                        for k in ("camera_feat", "lidar_feat", "pre_fusion", "post_fusion")})
            out[variant, part] = res
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' JSON and outputs, and JAX's outputs (made while the
    ranks run)."""
    out = tmp_path_factory.mktemp("tp")
    res, jax_out = run_rank_script(__file__, 4, out, while_running=jax_outputs)
    arrays = [dict(np.load(out / f"out{r}.npz")) for r in range(4)]
    return res, arrays, jax_out


@pytest.mark.parametrize("part", ["tp", "sp"])
@pytest.mark.parametrize("variant", JAX_VARIANTS)
def test_split_teacher_matches_jax_on_its_4x2_mesh(ranks, variant, part):
    """The logits and every tap of the port's split teacher (each data
    stripe's rows, from the rank of model coordinate 0 and 1 alike) against
    JAX's forward on its 4x2 mesh, within 1e-5 of scale: the concat teacher (the
    concat of two split projections is gathered first), the weighted one
    with its fused gate (its Cout-split weights gathered for K2) and the x4
    head (transposed convs split on their input channels)."""
    _, arrays, jax_out = ranks
    want = jax_out[variant, part]
    L = B // 2
    for r, a in enumerate(arrays):
        d = r // 2
        for k, w in want.items():
            err = scaled_err(a[f"{variant}/{part}/{k}"], w[d * L:(d + 1) * L])
            assert err <= ATOL, (r, k, err)


@pytest.mark.parametrize("part", ["tp", "sp"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_split_teacher_matches_the_whole_teacher(ranks, variant, part):
    """Every variant, split, against the same teacher whole in the same
    rank, within 1e-5 of scale: the fused_inference blocks run K3 whole (gathered in; under sp
    along H, sliced back), the indivisible LiDAR width stays whole and is
    not gathered again."""
    res, _, _ = ranks
    for r, rr in enumerate(res):
        err = rr["forward"][variant][part]["err"]
        assert max(err.values()) <= ATOL, (r, err)


def test_gathers_per_forward(ranks):
    """Structural counts, the same on every rank: tp gathers each split
    activation that meets a contraction once (the indivisible variant one
    fewer: its LiDAR MLP's first layer is whole, so its second takes it as
    it is); sp makes one halo exchange a 3x3 conv (stem + 5 depthwise) and
    gathers the four multi-scale maps (and each fused block's input)."""
    res, _, _ = ranks

    def counts(rr):
        return {(v, p): (r["gathers"], r["halos"]) for v, x in rr["forward"].items()
                for p, r in x.items()}
    f = res[0]["forward"]
    assert all(counts(rr) == counts(res[0]) for rr in res[1:])
    assert f["indivisible"]["tp"]["gathers"] == f["concat"]["tp"]["gathers"] - 1
    assert f["concat"]["sp"]["halos"] == 6 and f["concat"]["sp"]["gathers"] == 4
    assert f["fused"]["sp"]["gathers"] == 4 + 5


def test_concat_trap_is_real(ranks):
    """The trap the concat plan avoids: feeding the fusion's depthwise conv
    the concat of the two split projections ([cam_m, lid_m], not rank m's
    slice of [cam, lid]) moves its output far past the tolerance."""
    res, _, _ = ranks
    for rr in res:
        assert rr["naive_concat_err"] > 100 * ATOL, rr["naive_concat_err"]


def test_sp_edge_rows_are_zero_after_the_activation(ranks):
    """The sp trap inside an InvertedResidual: padding the depthwise conv's
    input at a global edge with ReLU6(BN(expand(0))) instead of zeros
    changes the output (the BN biases make that row nonzero), so the
    split teacher's exact match above rests on the zero rows."""
    res, _, _ = ranks
    for rr in (res[0], res[2]):  # the ranks at model coordinate 0, each a global top edge
        assert rr["edge_padding_err"] > 100 * ATOL, rr["edge_padding_err"]


def test_ensemble_under_tp(ranks):
    """A two-member ensemble, each member split by channel: logits and
    taps within 1e-5 of scale of the one-process ensemble's."""
    res, _, _ = ranks
    for rr in res:
        assert rr["ensemble"]["layout"] == "tp" and rr["ensemble"]["members"] == 2
        assert rr["ensemble"]["err"] <= ATOL, rr["ensemble"]


def test_fsdp_on_the_2d_mesh_shards_over_the_data_axis(ranks):
    """fsdp on the 2x2 mesh: each leaf split over the data axis's two ranks
    only (not the world's four), a rank's bytes about half; the outputs
    equal the one-process teacher's bit for bit."""
    res, _, _ = ranks
    for rr in res:
        f = rr["fsdp"]
        assert f["axis_size"] == 2 and f["equal"], f
        assert f["bytes_per_rank"] <= 0.55 * f["bytes_full"], f


def test_tp_teacher_bytes_about_half(ranks):
    res, _, _ = ranks
    for rr in res:
        t = rr["steps"]["tp"]
        assert 0.45 * t["bytes_full"] <= t["bytes_per_rank"] <= 0.55 * t["bytes_full"], t


@pytest.mark.parametrize("part", ["tp", "sp"])
def test_two_kd_steps_match_one_process(ranks, part):
    """Two KD steps on the 2x2 mesh (each rank its data stripe's rows, the
    teacher split) against the port's one-process steps over the global
    batch: each step's global loss, then the parameters and the EMA after
    the two steps, within 1e-6 of scale plus 10x the one-process run's own
    spread under a 1e-6 weight perturbation."""
    res, _, _ = ranks
    for r, rr in enumerate(res):
        s = rr["steps"][part]
        for q, (err, spread, scale) in s["held"].items():
            assert err <= 1e-6 * scale + 10 * spread, (r, q, err, spread, scale)


@pytest.mark.parametrize("part", ["tp", "sp"])
def test_replicas_are_bit_equal(ranks, part):
    """After the steps every rank holds the same parameters, BN buffers,
    EMA and projections bit for bit: along the model axis (the broadcast
    from model coordinate 0) and across the data axis (the all-reduce)."""
    res, _, _ = ranks
    first = res[0]["steps"][part]["digest"]
    for rr in res[1:]:
        assert rr["steps"][part]["digest"] == first


# -- the ranks -----------------------------------------------------------------


def _kd_runs(mesh, out: Path, rank: int) -> dict:
    """tp and sp: two KD steps on the mesh against the one-process steps."""
    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.training import DistillationTrainer
    batch = kd_batch()
    L = B // mesh.data_size
    local = {k: v[mesh.data_rank * L:(mesh.data_rank + 1) * L] for k, v in batch.items()}

    def state(tr):
        return torch.cat([p.detach().reshape(-1).double() for p in tr.params.values()]
                         + [e.reshape(-1).double() for e in tr.ema_params.values()])

    def one_process(perturb):
        with pm.using(None):
            tr = DistillationTrainer(kd_config("tp", str(out / f"one{rank}"), mp=1), [], [],
                                     device="cpu")
            if perturb:
                g = torch.Generator().manual_seed(3)
                with torch.no_grad():
                    for p in tr.params.values():
                        p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
                    for k, e in tr.ema_params.items():
                        e.copy_(tr.params[k])
            losses = [float(tr.train_step(batch)[0]) for _ in range(2)]
            return losses, state(tr)
    ref, pert = one_process(0.0), one_process(1e-6)
    runs = {}
    for part in ("tp", "sp"):
        tr = DistillationTrainer(kd_config(part, str(out / f"{part}{rank}")), [], [],
                                 device="cpu", mesh=mesh)
        losses = []
        for _ in range(2):
            loss = tr.train_step(local)[0]
            losses.append(float(pm.all_reduce_(loss.clone(), mesh=mesh.data_axis())))
        got = state(tr)
        held = {f"loss{i}": (abs(losses[i] - ref[0][i]), abs(pert[0][i] - ref[0][i]),
                             abs(ref[0][i])) for i in range(2)}
        held["state"] = (float((got - ref[1]).norm()), float((pert[1] - ref[1]).norm()),
                         float(ref[1].norm()))
        sh = tr.teacher_shards
        runs[part] = {"held": held, "layout": tr.teacher_layout,
                      "digest": digest(list(tr.params.values()) + list(tr.model.buffers())
                                       + list(tr.ema_params.values())),
                      "bytes_per_rank": getattr(sh, "bytes_per_rank", None),
                      "bytes_full": getattr(sh, "bytes_full", None)}
    return runs


def _rank(rank, world, init, out: Path):
    import conftest  # noqa: F401 (JAX on the CPU, as in the test process)

    from lmsu_tpu_torch.config import MeshConfig
    from lmsu_tpu_torch.models.layers import apply_seq
    from lmsu_tpu_torch.parallel import mesh as pm
    from lmsu_tpu_torch.parallel import tp as ptp
    from lmsu_tpu_torch.training import DistillationTrainer
    torch.set_num_threads(1)
    torch.manual_seed(0)
    mesh = pm.make_mesh(MeshConfig(model_parallel=2), device="cpu", init_method=init,
                        rank=rank, world_size=world, timeout_s=120)
    img, pts = tiny_batch()
    L = B // mesh.data_size
    rows = slice(mesh.data_rank * L, (mesh.data_rank + 1) * L)
    img, pts = torch.from_numpy(img[rows]), torch.from_numpy(pts[rows])
    res, arrays = {"forward": {}}, {}
    with torch.no_grad():
        for variant in VARIANTS:
            with pm.using(None):
                want = outputs(tiny_teacher(variant)(img, pts, return_intermediates=True))
            res["forward"][variant] = {}
            for part, shard in (("tp", ptp.shard_teacher_tp), ("sp", ptp.shard_teacher_sp)):
                teacher, sh = shard(tiny_teacher(variant), mesh)
                got = outputs(teacher(img, pts, return_intermediates=True))
                res["forward"][variant][part] = {
                    "err": {k: scaled_err(got[k], want[k]) for k in want},
                    "gathers": sh.gathers, "halos": getattr(sh, "halos", None)}
                for k, v in got.items():
                    arrays[f"{variant}/{part}/{k}"] = v

        # The concat trap: the split projections concatenated as they are.
        t, _ = ptp.shard_teacher_tp(tiny_teacher("concat"), mesh)
        with pm.using(None):
            whole = tiny_teacher("concat")
            _, taps = whole(img, pts, return_intermediates=True)
            pre = taps["pre_fusion"]
        fuse = list(t.model.fusion.fuse)[:3]  # the split depthwise conv, its BN and ReLU
        cam_c = whole.fusion.camera_proj.conv[0].out_channels
        m = mesh.model_rank
        naive = torch.cat([pre[:, :cam_c].chunk(2, 1)[m], pre[:, cam_c:].chunk(2, 1)[m]], 1)
        good = t.local(ptp._Act(pre, False))
        y_naive = t.seq(fuse, ptp._Act(naive, True)).t
        y_good = t.seq(fuse, ptp._Act(good, True)).t
        res["naive_concat_err"] = float((y_naive - y_good).abs().max())

        # The sp trap: the global top edge padded with the activation of a zero row.
        if mesh.model_rank == 0:
            blk = whole.camera_encoder.stage3
            with pm.using(None):
                x = whole.camera_encoder.stage2(whole.camera_encoder.stage1(
                    apply_seq(whole.camera_encoder.stem, img.permute(0, 3, 1, 2))))
                c = list(blk.conv)
                e = apply_seq(c[:3], x)
                act0 = apply_seq(c[:3], torch.zeros_like(x[:, :, :1]))
                dw = c[3]
                right = torch.nn.functional.conv2d(e, dw.weight, None, 1, 1, 1, dw.groups)
                padded = torch.cat([act0, e, act0], 2)
                wrong = torch.nn.functional.conv2d(padded, dw.weight, None, 1, (0, 1), 1,
                                                   dw.groups)
            res["edge_padding_err"] = float((wrong - right).abs().max())

    # A two-member ensemble under tp, fsdp over the data axis, both by the trainer.
    batch = kd_batch()
    local = {k: v[rows] for k, v in batch.items()}
    with pm.using(None):
        one = DistillationTrainer(kd_config("tp", str(out / f"e{rank}"), ensemble=2, mp=1),
                                  [], [], device="cpu")
        want_e = outputs(one.teacher_forward(local))
        one_f = DistillationTrainer(kd_config("tp", str(out / f"f{rank}"), mp=1), [], [],
                                    device="cpu")
        want_f = one_f.teacher_forward(local)
    ens = DistillationTrainer(kd_config("tp", str(out / f"E{rank}"), ensemble=2), [], [],
                              device="cpu", mesh=mesh)
    got_e = outputs(ens.teacher_forward(local))
    res["ensemble"] = {"layout": ens.teacher_layout,
                       "members": len(ens.teacher_shards.members),
                       "err": max(scaled_err(got_e[k], want_e[k]) for k in want_e)}
    fs = DistillationTrainer(kd_config("fsdp", str(out / f"F{rank}")), [], [], device="cpu",
                             mesh=mesh)
    got_f = fs.teacher_forward(local)
    sh = fs.teacher_shards
    res["fsdp"] = {"axis_size": sh.mesh.world_size, "bytes_per_rank": sh.bytes_per_rank,
                   "bytes_full": sh.bytes_full,
                   "equal": bool(torch.equal(got_f[0], want_f[0]) and all(
                       torch.equal(got_f[1][k], want_f[1][k]) for k in want_f[1]))}
    res["steps"] = _kd_runs(mesh, out, rank)
    try:
        DistillationTrainer(kd_config("sp", str(out / f"h{rank}"), image=40), [], [],
                            device="cpu", mesh=mesh)
        res["sp_height_refusal"] = "none"
    except ValueError as e:
        res["sp_height_refusal"] = str(e)
    np.savez(out / f"out{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    pm.destroy()


if __name__ == "__main__":
    _r, _w, _i, _o, _ = rank_args(sys.argv[1:])
    _rank(_r, _w, _i, _o)
