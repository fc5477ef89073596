"""The port's losses, metrics, LR schedule, AdamW step, gradient clipping and
EMA against the JAX package's (and optax's), on the CPU, on inputs made
from a numpy seed.

Tolerances: losses rtol 1e-6 / atol 1e-7 in f32 (the same f32 formulas,
reduced in another order); bf16 feature taps rtol 1e-5 (both round the
projection to bf16 and accumulate in f32); confusion matrices and mIoU
exactly; the schedule rtol 1e-6 (float32 cos of two libraries); AdamW
parameters after five steps rtol 1e-5 / atol 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmsu_tpu.ops import losses as jl
from lmsu_tpu.ops import metrics as jm
from lmsu_tpu.training import schedule as js
from lmsu_tpu.training.trainer import make_optimizer as jax_make_optimizer
from lmsu_tpu.training.trainer import update_ema as jax_update_ema
from lmsu_tpu_torch.config import TrainConfig
from lmsu_tpu_torch.ops import losses as pl
from lmsu_tpu_torch.ops import metrics as pm
from lmsu_tpu_torch.training import make_optimizer, update_ema
from lmsu_tpu_torch.training import schedule as ps
from lmsu_tpu_torch.training.trainer import clip_by_global_norm

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _logits_targets(rng, ignore):
    logits = rng.normal(0, 2, (2, 8, 8, 3)).astype(np.float32)
    targets = rng.integers(0, 3, (2, 8, 8))
    if ignore == "some":
        targets[rng.uniform(size=targets.shape) < 0.3] = -1
    elif ignore == "all":
        targets[:] = -1
    return logits, targets


@pytest.mark.parametrize("ignore", ["none", "some", "all"])
@pytest.mark.parametrize("weights", [None, (0.4, 3.5, 1.0)], ids=["unweighted", "weighted"])
def test_weighted_cross_entropy_matches_jax(rng, ignore, weights):
    logits, targets = _logits_targets(rng, ignore)
    cw = None if weights is None else np.asarray(weights, np.float32)
    want = float(jl.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                           None if cw is None else jnp.asarray(cw), -1))
    got = pl.weighted_cross_entropy(_t(logits), _t(targets), None if cw is None else _t(cw), -1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **TOL)
    if ignore == "all":  # a padded final batch: 0, where F.cross_entropy gives NaN
        assert float(got) == 0.0


@pytest.mark.parametrize("sample_weight", [None, (1.0, 0.0)], ids=["all", "masked"])
def test_kd_logit_kl_matches_jax(rng, sample_weight):
    s = rng.normal(0, 2, (2, 8, 8, 2)).astype(np.float32)
    t = rng.normal(0, 2, (2, 8, 8, 2)).astype(np.float32)
    sw = None if sample_weight is None else np.asarray(sample_weight, np.float32)
    want = float(jl.kd_logit_kl(jnp.asarray(s), jnp.asarray(t), 2.0,
                                None if sw is None else jnp.asarray(sw)))
    got = pl.kd_logit_kl(_t(s), _t(t), 2.0, None if sw is None else _t(sw))
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("projected", [False, True], ids=["same_width", "projected"])
def test_feature_matching_loss_matches_jax(rng, dtype, projected):
    ct = 12 if projected else 8
    s = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    t = rng.normal(0, 1, (2, 4, 4, ct)).astype(np.float32)
    p = rng.normal(0, 0.3, (ct, 8)).astype(np.float32) if projected else None
    sw = np.asarray([1.0, 0.0], np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    for w in (None, sw):
        with jax.default_matmul_precision("highest"):
            want = float(jl.feature_matching_loss(
                jnp.asarray(s, jdt), jnp.asarray(t, jdt), None if p is None else jnp.asarray(p),
                None if w is None else jnp.asarray(w)))
        got = pl.feature_matching_loss(_t(s).to(tdt), _t(t).to(tdt),
                                       None if p is None else _t(p), None if w is None else _t(w))
        np.testing.assert_allclose(float(got), want,
                                   **(TOL if dtype == "f32" else dict(rtol=1e-5, atol=1e-6)))


@pytest.mark.parametrize("alpha_kl", [0.5, 0.0])
def test_kd_total_loss_matches_jax(rng, alpha_kl):
    taps = ("camera_feat", "lidar_feat")
    s_logits = rng.normal(0, 1, (2, 8, 8, 2)).astype(np.float32)
    t_logits = rng.normal(0, 1, (2, 8, 8, 2)).astype(np.float32)
    targets = rng.integers(0, 2, (2, 8, 8))
    targets[1] = -1
    s_feats = {k: rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32) for k in taps}
    t_feats = {k: rng.normal(0, 1, (2, 8, 8, 6)).astype(np.float32) for k in taps}
    projs = {k: rng.normal(0, 0.4, (6, 4)).astype(np.float32) for k in taps}
    sw = np.asarray([1.0, 0.0], np.float32)
    kw = dict(ignore_index=-1, temperature=2.0, alpha_kl=alpha_kl, beta_feature=0.5,
              feature_taps=taps)
    with jax.default_matmul_precision("highest"):
        jloss, jparts = jl.kd_total_loss(
            jnp.asarray(s_logits), jnp.asarray(t_logits),
            {k: jnp.asarray(v) for k, v in s_feats.items()},
            {k: jnp.asarray(v) for k, v in t_feats.items()}, jnp.asarray(targets),
            class_weights=jnp.asarray([0.4, 3.5]),
            projections={k: jnp.asarray(v) for k, v in projs.items()},
            sample_weight=jnp.asarray(sw), **kw)
    ploss, pparts = pl.kd_total_loss(
        _t(s_logits), _t(t_logits), {k: _t(v) for k, v in s_feats.items()},
        {k: _t(v) for k, v in t_feats.items()}, _t(targets),
        class_weights=torch.tensor([0.4, 3.5]), projections={k: _t(v) for k, v in projs.items()},
        sample_weight=_t(sw), **kw)
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    assert pparts.keys() == jparts.keys()
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]), **TOL, err_msg=k)
    if alpha_kl == 0.0:
        assert float(pparts["kl"]) == 0.0


@pytest.mark.parametrize("ignore", ["some", "all"])
def test_confusion_matrix_and_iou_match_jax(rng, ignore):
    logits, targets = _logits_targets(rng, ignore)
    targets[0, 0, :3] = [5, -3, 7]  # out-of-range targets are dropped too
    want = np.asarray(jm.confusion_matrix(jnp.asarray(logits), jnp.asarray(targets), 3, -1))
    got = pm.confusion_matrix(_t(logits), _t(targets), 3, -1)
    assert np.array_equal(got.numpy(), want)
    assert pm.iou_from_confusion(got.numpy()) == jm.iou_from_confusion(want)
    if ignore == "all":
        assert got.sum() == 0 and pm.iou_from_confusion(got)["miou"] == 0.0


def test_schedule_matches_jax():
    for lr, eta, epochs, spe in ((1e-3, 1e-5, 20, 7), (3e-4, 3e-4, 3, 1), (1e-2, 0.0, 5, 4)):
        jsched = js.cosine_epoch_schedule(lr, eta, epochs, spe)
        psched = ps.cosine_epoch_schedule(lr, eta, epochs, spe)
        for step in range(0, (epochs + 2) * spe, max(1, spe // 2)):
            np.testing.assert_allclose(psched(step), float(jsched(jnp.int32(step))),
                                       rtol=1e-6, err_msg=f"step {step}")
        for e in range(epochs + 1):
            assert ps.lr_at_epoch(lr, eta, epochs, e) == js.lr_at_epoch(lr, eta, epochs, e)


@pytest.mark.parametrize("clip", [None, 0.05], ids=["no_clip", "clip"])
def test_adamw_steps_match_optax(rng, clip):
    """make_optimizer with the LR written per step = optax.adamw over the
    epoch staircase (decay on every parameter), with optax's global-norm
    clipping. Two epochs of three steps cross a schedule step."""
    tc = TrainConfig(lr=1e-2, eta_min=1e-4, num_epochs=2, weight_decay=1e-2,
                     grad_clip_norm=clip)
    shapes = {"w": (4, 3), "b": (3,)}
    init = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tx = jax_make_optimizer(tc, steps_per_epoch=3)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in init.items()}
    opt, schedule = make_optimizer(tc, params.values(), steps_per_epoch=3)
    for step, g in enumerate(grads):
        for k, p in params.items():
            p.grad = _t(g[k].copy())
        if clip is not None:
            clip_by_global_norm([p.grad for p in params.values()], clip)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_clip_by_global_norm_matches_optax(rng):
    g = {"a": rng.normal(0, 1, (5,)).astype(np.float32),
         "b": rng.normal(0, 1, (2, 3)).astype(np.float32)}
    norm = float(np.sqrt(sum((v ** 2).sum() for v in g.values())))
    for max_norm in (norm / 3, norm * 2):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in g.items()}, None)
        got = [_t(g["a"].copy()), _t(g["b"].copy())]
        clip_by_global_norm(got, max_norm)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want["a"]), rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want["b"]), rtol=1e-6)


def test_update_ema_matches_jax(rng):
    e = {"x": rng.normal(0, 1, (3, 2)).astype(np.float32)}
    p = {"x": rng.normal(0, 1, (3, 2)).astype(np.float32)}
    want = jax_update_ema(0.9, {"x": jnp.asarray(e["x"])}, {"x": jnp.asarray(p["x"])})
    got = update_ema(0.9, {"x": _t(e["x"].copy())}, {"x": _t(p["x"])})
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=1e-6, atol=1e-7)
    same = {"x": _t(e["x"].copy())}
    assert update_ema(None, same, {"x": _t(p["x"])}) is same
    assert np.array_equal(same["x"].numpy(), e["x"])
