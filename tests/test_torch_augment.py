"""The port's augmentation (lmsu_tpu_torch/ops/augment.py) against the JAX
package's (lmsu_tpu/ops/augment.py), on the CPU.

The port cannot reproduce jax.random, so `apply_augment` is fed JAX's own
draws: the key split six ways as `augment_batch` splits it, each draw made
with the call `augment_batch` makes. Tolerances: the flips, masks, labels
and mirrored points exactly; photometric terms and jitter within 1e-6
(f32; the per-sample contrast mean sums in another order), and so the
uint8 -> float conversion: compiled, XLA multiplies by 1/255, one ulp off
the true division that the port (and its model) make. The port's own
stream is keyed by the step: the same step gives the same draws, so a
resume reproduces them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import AugmentConfig as JAug
from lmsu_tpu.ops import augment as jaug
from lmsu_tpu_torch.config import AugmentConfig
from lmsu_tpu_torch.ops import augment

torch.set_num_threads(2)

PC4 = (-50.0, 50.0, -50.0, 50.0)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _batch(rng, B=3, N=300, H=16, W=16, ih=64, iw=64, uint8=False, prior=False):
    pts = rng.uniform(-60, 60, (B, N, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 2, (B, N))
    pts[..., 3] = rng.uniform(0, 1, (B, N))
    image = (rng.integers(0, 256, (B, ih, iw, 3)).astype(np.uint8) if uint8
             else rng.uniform(0, 1, (B, ih, iw, 3)).astype(np.float32))
    out = {"image": image, "points": pts,
           "segmentation": rng.integers(-1, 3, (B, H, W)).astype(np.int32)}
    if prior:
        out["point_valid"] = rng.uniform(size=(B, N)) > 0.3
    return out


def jax_draws(key, cfg, image_shape, points_shape):
    """augment_batch's draws from `key`, in the port's draw layout."""
    B = points_shape[0]
    k_flip, k_bri, k_con, k_noise, k_drop, k_jit = jax.random.split(key, 6)
    d = dict.fromkeys(("flip", "brightness", "contrast", "image_noise", "keep", "jitter"))
    if cfg.hflip_prob > 0:
        d["flip"] = jax.random.bernoulli(k_flip, cfg.hflip_prob, (B,))
    if cfg.brightness > 0:
        d["brightness"] = jax.random.uniform(k_bri, (B, 1, 1, 1), minval=-cfg.brightness,
                                             maxval=cfg.brightness)
    if cfg.contrast > 0:
        d["contrast"] = jax.random.uniform(k_con, (B, 1, 1, 1), minval=-cfg.contrast,
                                           maxval=cfg.contrast)
    if cfg.image_noise_std > 0:
        d["image_noise"] = jax.random.normal(k_noise, image_shape, jnp.float32)
    if cfg.point_dropout > 0:
        d["keep"] = jax.random.uniform(k_drop, points_shape[:2]) >= cfg.point_dropout
    if cfg.point_jitter_xy > 0 or cfg.point_jitter_z > 0 or cfg.intensity_jitter > 0:
        d["jitter"] = jax.random.normal(k_jit, points_shape, jnp.float32)
    return {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in d.items()}


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["segmentation"] = out["segmentation"].long()
    return out


CASES = {
    "standard": dict(hflip_prob=0.5, brightness=0.1, contrast=0.1, image_noise_std=0.02,
                     point_dropout=0.05),
    "recipe": dict(brightness=0.1, contrast=0.1, image_noise_std=0.02, point_dropout=0.05),
    "photometric": dict(brightness=0.2, contrast=0.3, image_noise_std=0.05),
    "hflip_only": dict(hflip_prob=0.7),
    "hflip_mirror": dict(hflip_prob=0.7, flip_image_mode="mirror"),
    "dropout": dict(point_dropout=0.3),
    "jitter": dict(point_jitter_xy=0.2, point_jitter_z=0.05, intensity_jitter=0.03),
}


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_augment_matches_jax_given_its_draws(rng, case, uint8):
    """Dropout runs with and without a prior point_valid (the case
    "dropout" ANDs into one)."""
    kw = CASES[case]
    cfg, jcfg = AugmentConfig(enabled=True, **kw), JAug(enabled=True, **kw)
    batch = _batch(rng, uint8=uint8, prior=case == "dropout")
    key = jax.random.PRNGKey(7)
    fn = jax.jit(lambda k, b: jaug.augment_batch(k, b, jcfg, pc_range=PC4, ignore_index=-1))
    want = jax.tree_util.tree_map(np.asarray, fn(key, {k: jnp.asarray(v)
                                                       for k, v in batch.items()}))
    draws = jax_draws(key, jcfg, batch["image"].shape, batch["points"].shape)
    got = augment.apply_augment(_torch_batch(batch), draws, cfg, PC4, ignore_index=-1)

    assert set(got) == set(want)
    np.testing.assert_array_equal(got["segmentation"].numpy(), want["segmentation"])
    if "point_valid" in want:
        np.testing.assert_array_equal(got["point_valid"].numpy(), want["point_valid"])
    pts = got["points"].numpy()
    if draws["jitter"] is None:  # mirrored or untouched: exact
        np.testing.assert_array_equal(pts, want["points"])
    else:
        np.testing.assert_allclose(pts, want["points"], rtol=0, atol=1e-6 * 60)
    img = got["image"].numpy()
    assert img.dtype == want["image"].dtype
    if case in ("hflip_only", "hflip_mirror", "dropout", "jitter") and not uint8:
        np.testing.assert_array_equal(img, want["image"])
    else:
        np.testing.assert_allclose(img, want["image"], rtol=0, atol=1e-6)
    if draws["flip"] is not None:
        assert 0 < int(draws["flip"].sum()) < len(draws["flip"])  # both branches taken


@pytest.mark.parametrize("W", [4, 7, 16, 64])
def test_flip_bev_labels_matches_jax(rng, W):
    seg = rng.integers(-1, 4, (3, 5, W)).astype(np.int32)
    want = np.asarray(jaug.flip_bev_labels(jnp.asarray(seg), ignore_index=-1))
    got = augment.flip_bev_labels(torch.from_numpy(seg), ignore_index=-1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., -1] == -1).all()


@pytest.mark.parametrize("mode", ["aligned", "mirror"])
@pytest.mark.parametrize("iw, grid_w", [(64, 16), (64, 64), (50, 16), (30, 7)],
                         ids=["4px", "1px", "50over16", "30over7"])
def test_flip_image_matches_jax(rng, mode, iw, grid_w):
    """Including widths that grid_w does not divide (round(iw / grid_w))."""
    img = rng.uniform(0, 1, (2, 6, iw, 3)).astype(np.float32)
    want = np.asarray(jaug.flip_image(jnp.asarray(img), mode, grid_w))
    got = augment.flip_image(torch.from_numpy(img), mode, grid_w).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="flip_image_mode"):
        augment.flip_image(torch.from_numpy(img), "rotate", grid_w)


def test_check_augment_compat_refuses_as_jax_does():
    movers = [dict(hflip_prob=0.5), dict(point_dropout=0.1), dict(point_jitter_xy=0.1)]
    for kw in movers:
        for mod, Cfg in ((augment, AugmentConfig), (jaug, JAug)):
            with pytest.raises(ValueError, match="sorted_pallas"):
                mod.check_augment_compat(Cfg(enabled=True, **kw), "sorted_pallas")
    with pytest.raises(ValueError, match="cache_teacher"):
        augment.check_augment_compat(AugmentConfig(enabled=True, hflip_prob=0.5), "pallas",
                                     cache_teacher=True)
    # Allowed: photometric / z / intensity terms with sorted_pallas; the
    # noisy-student composition with the cache; anything while disabled.
    augment.check_augment_compat(AugmentConfig(enabled=True, brightness=0.2, point_jitter_z=0.1,
                                               intensity_jitter=0.1), "sorted_pallas",
                                 cache_teacher=True)
    augment.check_augment_compat(AugmentConfig(enabled=True, brightness=0.2,
                                               point_dropout=0.1), "xla", cache_teacher=True)
    augment.check_augment_compat(AugmentConfig(hflip_prob=0.5), "sorted_pallas",
                                 cache_teacher=True)
    for kw in ({}, *movers, dict(brightness=0.1)):
        a, j = AugmentConfig(enabled=True, **kw), JAug(enabled=True, **kw)
        assert (a.moves_points, a.spatial) == (j.moves_points, j.spatial)
    assert {f.name: f.default for f in dataclasses.fields(AugmentConfig)} == \
        {f.name: f.default for f in dataclasses.fields(JAug)}


def test_draws_are_keyed_by_step(rng):
    """The same (seed, step) gives the same draws, another step other ones:
    a trainer resumed at step k draws what the uninterrupted run drew."""
    cfg = AugmentConfig(enabled=True, **CASES["standard"], point_jitter_z=0.1)
    b = _torch_batch(_batch(rng))

    def draws(step, seed=0):
        gen = augment.step_generator(seed, cfg.seed_offset, step, torch.device("cpu"))
        return augment.draw_augment(gen, cfg, b)
    first, again, other, seeded = draws(3), draws(3), draws(4), draws(3, seed=1)
    assert all(v is not None for v in first.values())  # every term is on
    for k, v in first.items():
        assert torch.equal(v, again[k]), k
        if v.dtype != torch.bool:
            assert not torch.equal(v, other[k]) and not torch.equal(v, seeded[k]), k
    assert first["image_noise"].shape == b["image"].shape
    assert first["keep"].shape == b["points"].shape[:2]
    assert first["brightness"].abs().max() <= 0.1 and first["flip"].dtype == torch.bool
