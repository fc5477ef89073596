"""Training-data augmentation on the device, inside the train step.

Counterpart of lmsu_tpu/ops/augment.py. Every term is fixed-shape and
branch-free per sample (a `where` select, never a Python branch on data),
on the batch already on the device, so the host pipeline and the teacher
cache's fill (which must see clean inputs) are untouched.

The JAX package draws from `jax.random`, which the port cannot reproduce.
So augmentation is split in two:
  * `draw_augment(generator, cfg, batch)` makes the random draws from an
    explicit torch.Generator on the batch's device (the trainer seeds it
    from (seed ^ seed_offset, step), `step_generator`, as the JAX trainer
    folds the step into its key), and
  * `apply_augment(batch, draws, cfg, ...)` is pure: given the JAX
    package's own draws it computes what `augment_batch` computes.

Geometric exactness: the rasterizer maps coordinates to cells with
floor(norm * (W-1)), which is not symmetric under reflection. Mirroring x
about the range centre sends cell c to W-2-c, not W-1-c, so the label flip
is not `[..., ::-1]`: new[c] = old[W-2-c] for c < W-1, the old last column
(reachable only at exactly x = x_max) max-merges into the new first one,
and the vacated new last column becomes ignore_index. The "aligned" image
flip mirrors, then shifts by one BEV cell's worth of pixels
(round(iw / grid_w)) and replicates the edge column; "mirror" is a plain
mirror for perspective cameras.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.config import AugmentConfig


def flip_bev_labels(seg: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """Exact label-grid mirror matching the point mirror x' = xm - x.
    seg [..., H, W] integer labels -> the same shape (module docstring)."""
    W = seg.shape[-1]
    body = seg[..., : W - 1].flip(-1)  # new col c = old col W-2-c
    first = torch.maximum(body[..., :1], seg[..., W - 1:])
    vacated = torch.full_like(seg[..., :1], ignore_index)
    return torch.cat([first, body[..., 1:], vacated], dim=-1)


def flip_image(image: torch.Tensor, mode: str, grid_w: int) -> torch.Tensor:
    """Mirror an NHWC image along its width ("aligned" or "mirror", module
    docstring)."""
    m = image.flip(-2)  # width is axis -2 in NHWC
    if mode == "mirror":
        return m
    if mode != "aligned":
        raise ValueError(f"flip_image_mode must be 'aligned' or 'mirror', got {mode!r}")
    s = max(1, round(image.shape[-2] / grid_w))
    edge = m[..., -1:, :].expand(*m.shape[:-2], s, m.shape[-1])
    return torch.cat([m[..., s:, :], edge], dim=-2)


def _image_terms(cfg: AugmentConfig) -> bool:
    return (cfg.hflip_prob > 0 or cfg.brightness > 0 or cfg.contrast > 0
            or cfg.image_noise_std > 0)


def step_generator(seed: int, seed_offset: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one train step: seeded from (seed ^ seed_offset,
    step), so the stream is keyed by the step and a resume at step k
    reproduces it."""
    state = np.random.SeedSequence([seed ^ seed_offset, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def draw_augment(generator: torch.Generator, cfg: AugmentConfig,
                 batch: Dict[str, torch.Tensor]) -> Dict[str, Optional[torch.Tensor]]:
    """The random draws of one step, on the batch's device (None for a term
    that is off): flip [B] bool (p = hflip_prob), brightness [B,1,1,1]
    ~ U(-b, b), contrast [B,1,1,1] log-scale ~ U(-c, c), image_noise
    [B,H,W,3] ~ N(0, 1), keep [B,N] bool (p = 1 - point_dropout), jitter
    [B,N,4] ~ N(0, 1). Scaling by the stds happens in apply_augment."""
    image, points = batch["image"], batch["points"]
    B, dev = points.shape[0], points.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + torch.rand(shape, generator=generator, device=dev) * (hi - lo)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {
        "flip": uniform((B,)) < cfg.hflip_prob if cfg.hflip_prob > 0 else None,
        "brightness": (uniform((B, 1, 1, 1), -cfg.brightness, cfg.brightness)
                       if cfg.brightness > 0 else None),
        "contrast": (uniform((B, 1, 1, 1), -cfg.contrast, cfg.contrast)
                     if cfg.contrast > 0 else None),
        "image_noise": normal(tuple(image.shape)) if cfg.image_noise_std > 0 else None,
        "keep": (uniform(tuple(points.shape[:2])) >= cfg.point_dropout
                 if cfg.point_dropout > 0 else None),
        "jitter": (normal(tuple(points.shape))
                   if cfg.point_jitter_xy > 0 or cfg.point_jitter_z > 0
                   or cfg.intensity_jitter > 0 else None),
    }


def apply_augment(batch: Dict[str, torch.Tensor], draws: Dict[str, Optional[torch.Tensor]],
                  cfg: AugmentConfig, pc_range: Tuple[float, float, float, float],
                  ignore_index: int = -1) -> Dict[str, torch.Tensor]:
    """The configured augmentations of one batch with the given draws (the
    JAX package's augment_batch). Pure; returns a new dict. `pc_range` is
    (x_min, x_max, y_min, y_max). The image comes back float32 in [0, 1]
    whenever an image term is on (the flip included), else unchanged."""
    out = dict(batch)
    image = batch["image"]
    if _image_terms(cfg) and image.dtype == torch.uint8:
        image = image.float() / 255.0

    # -- photometric (image only) ------------------------------------------
    if cfg.brightness > 0:
        image = image + draws["brightness"]
    if cfg.contrast > 0:
        mean = image.mean(dim=(1, 2), keepdim=True)  # per sample and channel
        image = mean + (image - mean) * torch.exp(draws["contrast"])
    if cfg.image_noise_std > 0:
        image = image + cfg.image_noise_std * draws["image_noise"].to(image.dtype)
    if cfg.brightness > 0 or cfg.contrast > 0 or cfg.image_noise_std > 0:
        image = image.clamp(0.0, 1.0)

    points = batch["points"]

    # -- geometric: lateral world mirror -------------------------------------
    if cfg.hflip_prob > 0:
        flip = draws["flip"]
        x_min, x_max = float(pc_range[0]), float(pc_range[1])
        seg = batch["segmentation"]
        mirrored_x = (x_min + x_max) - points[..., 0]
        points = torch.cat([torch.where(flip[:, None], mirrored_x, points[..., 0])[..., None],
                            points[..., 1:]], dim=-1)
        image = torch.where(flip[:, None, None, None],
                            flip_image(image, cfg.flip_image_mode, seg.shape[-1]), image)
        out["segmentation"] = torch.where(flip[:, None, None],
                                          flip_bev_labels(seg, ignore_index), seg)

    # -- point-cloud terms -----------------------------------------------------
    if cfg.point_dropout > 0:
        keep = draws["keep"]
        prior = batch.get("point_valid")
        out["point_valid"] = keep if prior is None else (prior & keep)
    if cfg.point_jitter_xy > 0 or cfg.point_jitter_z > 0 or cfg.intensity_jitter > 0:
        std = torch.tensor([cfg.point_jitter_xy, cfg.point_jitter_xy, cfg.point_jitter_z,
                            cfg.intensity_jitter], dtype=points.dtype, device=points.device)
        points = points + std * draws["jitter"].to(points.dtype)

    out["image"] = image
    out["points"] = points
    return out


def check_augment_compat(aug: AugmentConfig, scatter_impl: str,
                         cache_teacher: bool = False) -> None:
    """Fail at trainer build on an invalid combination (the AugmentConfig
    docstring's rules), with the JAX package's messages."""
    if not aug.enabled:
        return
    if aug.moves_points and scatter_impl == "sorted_pallas":
        raise ValueError(
            "augmentation terms that move or drop points (hflip_prob, "
            "point_dropout, point_jitter_xy) break the pre-sorted input "
            "contract of scatter_impl='sorted_pallas' (the host sorts "
            "points by BEV cell BEFORE the step runs). Use scatter_impl="
            "'xla' for augmented training, or restrict augmentation to "
            "photometric / z / intensity terms.")
    if aug.spatial and cache_teacher:
        raise ValueError(
            "hflip_prob > 0 is incompatible with KDConfig.cache_teacher: "
            "cached teacher taps are spatial maps of the unflipped world. "
            "Disable the cache (in-loop teacher sees the flipped batch) or "
            "drop the flip; photometric terms and point dropout/z-jitter "
            "DO compose with the cache as noisy-student KD.")
