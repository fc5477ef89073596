"""The slice as a whole: three KD train steps of the port against the JAX
package's, on the CPU, from the same weights.

The JAX side is bench.py's KD step (bench.py:177-204) with this slice's
opt-ins: the sorted scatter (Pallas, interpret mode here), the fused gate
and the fused feature-MSE loss (kd_total_loss_fused), optax.adamw(1e-3,
weight_decay=1e-3), on a fixed cell-sorted batch at bench.py's --tiny size
(B=2, 64^2 images, 512 points, 16^2 grid). The port runs the same step
through DistillationTrainer.train_step (the kernels' plain versions, as CPU
tensors take them), with the weights and projections carried across by
utils/weights.py; once with the teacher in the step and once with its
outputs computed beforehand (the cached teacher of bench.py:233-244).

Tolerances (f32, JAX at matmul precision "highest"). At this size the
reference is chaotic: when its weights move by 1e-6 of themselves (the same
three steps from weights * (1 + 1e-6 xi), xi ~ N(0, 1)), its first-step
gradients of the last camera stage move by up to 7% of their scale and the
three-step updates of most tensors by ~10% (ReLU6 kinks, BatchNorm over 8x8
maps of two samples, AdamW's m / sqrt(v) on small gradients). A larger
batch does not cure it. So each quantity is held to a fixed margin plus 10x
that spread N, with N capped:
  * per-step loss: |d| <= 1e-6 |loss| + min(10 N, 1e-4 |loss|);
  * first-step gradients, per tensor: max|d| <= 1e-3 max|g| + 1e-6 G
    + min(10 N, 0.1 max|g|), G the largest gradient of any tensor (the G
    term covers the eight biases that the next train-mode BatchNorm
    cancels: their true gradient is 0 and both sides give rounding noise);
  * three-step parameter updates D, per tensor, as a whole: |D_port - D_ref|_2
    <= 1e-2 |D_ref|_2 + min(10 N, 0.3 |D_ref|_2); for the eight cancelled
    biases only the size of the move, max|d| <= 2 * 3 * lr;
  * BatchNorm running statistics after the three steps: max|d| <= 1e-6 +
    1e-4 max|s| + min(10 N, 1e-6 + 1e-2 max|s|); the ten running means that
    absorb a cancelled bias's move are held to the largest shift it can give.
Per kind, the count of tensors whose error exceeds the fixed margin must not
exceed the count whose reference spread does (printed with -s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import jax_init_model

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import KDConfig as JKD
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.data.rasterize import bev_cell_key
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.ops.kd_loss_pallas import kd_total_loss_fused as jax_kd_total_loss_fused
from lmsu_tpu.training.distill import _tap_channels
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig)
from lmsu_tpu_torch.training import DistillationTrainer
from lmsu_tpu_torch.utils.weights import from_jax_projections, from_jax_variables

torch.set_num_threads(2)

B, IMG, NPTS, GRID = 2, 64, 512, (16, 16)
LR, STEPS = 1e-3, 3
PC6 = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)


def _student_kw(student=None):
    """bench.py's --tiny student with this slice's kernel opt-ins, with the
    fields of `student` in place of the defaults."""
    return {**dict(num_classes=2, fusion_type="weighted", fusion_out_channels=32,
                   camera_fpn_channels=16, use_pallas_fusion=True), **(student or {})}


def _lidar_kw(scatter="sorted_pallas"):
    return dict(feature_dim=32, mlp_dims=(16, 32), grid_size=GRID, scatter_impl=scatter)


def _batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)
    pts = rng.normal(0, 30, (B, NPTS, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-5, 3, (B, NPTS))
    order = np.argsort(bev_cell_key(pts, GRID, PC6), axis=-1, kind="stable")
    pts = np.take_along_axis(pts, order[..., None], axis=1)
    labels = rng.integers(0, 2, (B, GRID[0], GRID[1])).astype(np.int32)
    return images, pts, labels


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trajectory for a scatter_impl, made at first use."""
    runs = {}

    def get(scatter):
        if scatter not in runs:
            runs[scatter] = _jax_trajectory(scatter)
        return runs[scatter]
    return get


def _jax_trajectory(scatter, steps=STEPS, student=None, fused_train=False):
    """The JAX trajectory of `steps` steps: initial variables and
    projections, the per-step losses, the first step's gradients, the final
    parameters and BN statistics (all numpy); under "perturbed" the same
    from weights moved by 1e-6 of themselves. `student` overrides fields of
    the student's ModelConfig; `fused_train` is CameraEncoderConfig's."""
    scfg = JModel(camera=JCam(base_channels=8, fused_train=fused_train),
                  lidar=JLidar(**_lidar_kw(scatter)), **_student_kw(student))
    tcfg = jax_teacher_config(scfg, 2.0)
    student, teacher = jax_create_model(scfg), jax_create_model(tcfg)
    s_vars = jax_init_model(student, 0)
    t_vars = jax_init_model(teacher, 1)
    kd = JKD(enabled=True, use_pallas=True)
    s_ch, t_ch = _tap_channels(student, scfg), _tap_channels(teacher, tcfg)
    keys = jax.random.split(jax.random.PRNGKey(2), len(kd.feature_taps))
    projs = {tap: jax.random.normal(k, (t_ch[tap], s_ch[tap])) / np.sqrt(t_ch[tap])
             for tap, k in zip(kd.feature_taps, keys)}
    tx = optax.adamw(LR, weight_decay=1e-3)
    cw = jnp.asarray([0.4, 3.5], jnp.float32)
    images, pts, labels = (jnp.asarray(a) for a in _batch())

    def loss_fn(params, stats):
        t_logits, t_feats = teacher.apply(t_vars, images, pts, train=False,
                                          return_intermediates=True)
        t_logits, t_feats = jax.lax.stop_gradient((t_logits, t_feats))
        (s_logits, s_feats), mut = student.apply(
            {"params": params["model"], "batch_stats": stats}, images, pts, train=True,
            return_intermediates=True, mutable=["batch_stats"])
        loss, _ = jax_kd_total_loss_fused(
            s_logits, t_logits, s_feats, t_feats, labels, class_weights=cw, ignore_index=-1,
            temperature=kd.temperature, alpha_kl=kd.alpha_kl, beta_feature=kd.beta_feature,
            feature_taps=kd.feature_taps, projections=params["proj"])
        return loss, mut["batch_stats"]

    @jax.jit
    def step(params, stats, opt_state):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss, grads

    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731

    def trajectory(params):
        stats, opt_state = s_vars["batch_stats"], tx.init(params)
        losses, grads0 = [], None
        with jax.default_matmul_precision("highest"):
            for i in range(steps):
                params, stats, opt_state, loss, grads = step(params, stats, opt_state)
                losses.append(float(loss))
                grads0 = grads if i == 0 else grads0
        return {"losses": np.asarray(losses), "grads0": get(grads0), "final": get(params),
                "stats": get(stats)}

    params = {"model": s_vars["params"], "proj": projs}
    out = trajectory(params)
    # The reference's own rounding sensitivity: the same trajectory from
    # weights moved by 1e-6 of themselves.
    noise = np.random.default_rng(3)
    out["perturbed"] = trajectory(jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)), params))
    out.update({"s_vars": get(s_vars), "t_vars": get(t_vars), "proj": get(projs)})
    return out


def _port_config(scatter, save_dir, student=None, fused_train=False):
    model = ModelConfig(camera=CameraEncoderConfig(base_channels=8, fused_train=fused_train),
                        lidar=LidarEncoderConfig(**_lidar_kw(scatter)), **_student_kw(student))
    train = TrainConfig(lr=LR, eta_min=LR, weight_decay=1e-3, class_weights=(0.4, 3.5),
                        kd=KDConfig(enabled=True, use_pallas=True), save_dir=str(save_dir))
    return ExperimentConfig(model=model, data=DataConfig(batch_size=B), train=train)


def _port_state(variables, proj, cfg):
    """The JAX-layout (params, batch_stats, proj) as the port's flat
    {"model.<name>" / "proj.<tap>": tensor} of trainer.params and buffers."""
    sd = from_jax_variables(variables, cfg)
    out = {f"model.{k}": v for k, v in sd.items()}
    out.update({f"proj.{k}": v for k, v in from_jax_projections(proj).items()})
    return out


def hold_kd_steps(jax_run, save_dir, teacher, scatter, student=None, fused_train=False):
    """The port's DistillationTrainer.train_step, from jax_run's weights, for
    as many steps as jax_run took (`student` and `fused_train` as its),
    held to the protocol of this module's docstring; over one step, the
    loss, the gradients and the BatchNorm statistics only (an AdamW step of
    lr sign(g) is no comparison). Returns the trainer."""
    steps = len(jax_run["losses"])
    cfg = _port_config(scatter, save_dir, student, fused_train)
    images, pts, labels = _batch()
    batch = {"image": images, "points": pts, "segmentation": labels}
    tr = DistillationTrainer(cfg, [batch], [batch], device="cpu")
    tr.model.load_state_dict(from_jax_variables(jax_run["s_vars"], cfg.model))
    tr.teacher.load_state_dict(from_jax_variables(jax_run["t_vars"], tr.teacher_config))
    with torch.no_grad():
        for tap, p in from_jax_projections(jax_run["proj"]).items():
            tr.proj[tap].copy_(p)
    t_out = tr.teacher_forward(batch) if teacher == "cached" else None

    losses, grads0 = [], None
    for i in range(steps):
        loss, _ = tr.train_step(batch, teacher_out=t_out)
        losses.append(float(loss))
        if i == 0:
            grads0 = {k: p.grad.detach().clone() for k, p in tr.params.items()}
    ref, pert = jax_run, jax_run["perturbed"]
    counts = {}

    def held(kind, name, err, fixed, noise, cap):
        """err <= fixed + min(10 noise, cap); counts, per kind, the tensors
        whose error needs the noise term and those whose reference spread
        alone exceeds the fixed margin."""
        tol = fixed + min(10 * noise, cap)
        assert err <= tol, (f"{kind} {name}: {err:g} > {tol:g} (fixed {fixed:g}, "
                            f"reference spread {noise:g}, cap {cap:g})")
        c = counts.setdefault(kind, [0, 0, 0])
        c[0] += 1
        c[1] += int(err > fixed)
        c[2] += int(noise > fixed)

    for i in range(steps):
        held("loss", f"step {i}", abs(losses[i] - ref["losses"][i]),
             1e-6 * abs(ref["losses"][i]), abs(pert["losses"][i] - ref["losses"][i]),
             1e-4 * abs(ref["losses"][i]))

    def port_state(tree, stats):
        return _port_state({"params": tree["model"], "batch_stats": stats}, tree["proj"],
                           cfg.model)

    want_g = port_state(ref["grads0"], ref["s_vars"]["batch_stats"])
    noise_g = port_state(pert["grads0"], ref["s_vars"]["batch_stats"])
    assert set(grads0) == {k for k in want_g if k in tr.params}
    gmax = max(float(g.abs().max()) for g in grads0.values())
    cancelled = []
    for k, g in grads0.items():
        w = want_g[k]
        scale = float(w.abs().max())
        if scale <= 1e-7 * gmax:
            cancelled.append(k)
        held("grad", k, float((g - w).abs().max()), 1e-3 * scale + 1e-6 * gmax,
             float((noise_g[k] - w).abs().max()), 0.1 * scale)
    # The biases whose shift the next train-mode BatchNorm removes: their
    # true gradient is 0 (stage1-5's last BN, the LiDAR MLP's conv biases).
    assert len(cancelled) == 8, cancelled

    init = port_state({"model": ref["s_vars"]["params"], "proj": ref["proj"]},
                      ref["s_vars"]["batch_stats"])
    want_p = port_state(ref["final"], ref["stats"])
    noise_p = port_state(pert["final"], pert["stats"])
    for k, p in tr.params.items():
        if steps == 1:
            break
        if k in cancelled:
            # AdamW's m / sqrt(v) turns both sides' rounding noise into a
            # step of about lr per step, in no particular direction: only
            # the size of the move is held.
            assert float((p.detach() - want_p[k]).abs().max()) <= 2 * steps * LR, k
            continue
        # The update of three steps, as a whole: an element whose gradient
        # is near 0 flips the sign of its AdamW step under any rounding.
        d_ref = (want_p[k] - init[k]).norm()
        held("update", k, float((p.detach() - want_p[k]).norm() / d_ref), 1e-2,
             float((noise_p[k] - want_p[k]).norm() / d_ref), 0.3)
    # The running means that absorb a cancelled bias: the BatchNorm after
    # the next linear layer tracks the shift of that bias, whose update is
    # noise on both sides. Held to the largest shift such a move can give:
    # every input channel moved by 2 * steps * lr, through |W| of the layer.
    absorbing = {f"camera_encoder.stage{i}.conv.1" for i in (2, 3, 4, 5)} | {
        f"camera_fpn.laterals.stage{i}.conv.1" for i in (3, 4, 5)} | {
        f"lidar_encoder.encoder.point_mlp.{i}" for i in (1, 4, 7)}
    n_stats = 0
    for k, v in tr.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            n_stats += 1
            w = want_p[f"model.{k}"]
            err = float((v - w).abs().max())
            bn = k.rsplit(".", 1)[0]
            if bn in absorbing and k.endswith("running_mean"):
                conv = init[f"model.{bn[:-1]}{int(bn[-1]) - 1}.weight"]
                rows = float(conv.abs().flatten(1).sum(1).max())
                assert err <= 2 * steps * LR * max(1.0, rows), (k, err, rows)
                continue
            scale = float(w.abs().max())
            held("stat", k, err, 1e-6 + 1e-4 * scale,
                 float((noise_p[f"model.{k}"] - w).abs().max()), 1e-6 + 1e-2 * scale)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == steps, k
    assert n_stats == 2 * sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                              for m in tr.model.modules())
    print(f"[{teacher}] tensors checked / port error above the fixed margin / "
          f"reference spread above it: {counts}")
    for kind, (n, port_over, ref_over) in counts.items():
        # The port is held to the fixed margin as often as the reference's
        # own spread allows, and no more often.
        assert port_over <= ref_over, (kind, counts)
    return tr


@pytest.mark.parametrize("teacher, scatter", [("in_loop", "sorted_pallas"),
                                              ("cached", "sorted_pallas"), ("in_loop", "pallas")],
                         ids=["in_loop", "cached", "in_loop_pallas"])
def test_three_kd_steps_match_jax(jax_runs, teacher, scatter, tmp_path):
    """"in_loop_pallas": scatter_impl="pallas" (the unsorted scatter-max and
    the dense backward) in the student and the teacher, on both sides, on
    the same batch (the pallas scatter takes its cell-sorted points as it
    would take any order)."""
    tr = hold_kd_steps(jax_runs(scatter), tmp_path, teacher, scatter)
    assert sum(k.endswith("running_mean") for k in tr.model.state_dict()) == 29
