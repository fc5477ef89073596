"""Synthetic multi-modal dataset: the hermetic no-real-data fixture.

The port's own copy of lmsu_tpu/data/synthetic.py (numpy only), so the port
runs without the JAX package; its samples are byte-identical to the JAX
package's for the same (seed, index, difficulty), which
tests/test_torch_data.py pins.

Procedurally generated camera image + LiDAR cloud + BEV segmentation with
the item contract {image, points, segmentation, sample_token} of the
reference's PandaSet dataset (pandaset_dataset.py:136-141). Each sample
draws a road pattern in BEV space, scatters LiDAR points densely on the road
and sparsely off it, and renders a top-down camera view of the same scene.
"easy" is the original smoke fixture (all models saturate); "hard" is the
discriminative benchmark: thin roads, vehicles, camera-twin and lidar-twin
distractor lots, shadows, occluders, fog and LiDAR dropout wedges.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lmsu_tpu_torch.config import DataConfig


class SyntheticMultiModalDataset:
    def __init__(self, num_samples: int = 1000,
                 image_size: Tuple[int, int] = (256, 256),
                 grid_size: Tuple[int, int] = (64, 64),
                 max_points: int = 5000,
                 pc_range: Tuple[float, float, float, float] = (-50, 50, -50, 50),
                 seed: int = 0,
                 cache: bool = True,
                 difficulty: str = "easy"):
        if difficulty not in ("easy", "hard"):
            raise ValueError(f"difficulty must be 'easy' or 'hard', "
                             f"got {difficulty!r}")
        self.num_samples = num_samples
        self.image_size = image_size
        self.grid_size = grid_size
        self.max_points = max_points
        self.pc_range = pc_range
        self.seed = seed
        self.difficulty = difficulty
        # Samples are deterministic per (seed, idx); caching turns epoch 2+
        # host cost to ~zero (~0.9 MB/sample at the default shapes).
        self._cache: Dict[int, Dict[str, np.ndarray]] = {} if cache else None

    def __len__(self) -> int:
        return self.num_samples

    def _road_mask(self, rng: np.random.Generator) -> np.ndarray:
        """Random drivable-area pattern on the BEV grid."""
        H, W = self.grid_size
        yy, xx = np.mgrid[0:H, 0:W]
        kind = rng.integers(0, 3)
        width = rng.uniform(0.10, 0.22) * W
        if kind == 0:  # straight road, random angle/offset
            theta = rng.uniform(0, np.pi)
            offset = rng.uniform(-0.25, 0.25) * W
            d = (xx - W / 2) * np.cos(theta) + (yy - H / 2) * np.sin(theta)
            mask = np.abs(d - offset) < width
        elif kind == 1:  # curved road (quadratic)
            a = rng.uniform(-0.02, 0.02)
            b = rng.uniform(-0.5, 0.5)
            c = rng.uniform(0.3, 0.7) * W
            centre = a * (yy - H / 2) ** 2 + b * yy + c
            mask = np.abs(xx - centre) < width
        else:  # intersection: two perpendicular roads
            mask = (np.abs(xx - rng.uniform(0.3, 0.7) * W) < width) | \
                   (np.abs(yy - rng.uniform(0.3, 0.7) * H) < width)
        return mask.astype(np.int64)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        item = self._generate(idx)
        if self._cache is not None:
            self._cache[idx] = item
        return item

    def _generate(self, idx: int) -> Dict[str, np.ndarray]:
        if self.difficulty == "hard":
            return self._generate_hard(idx)
        return self._generate_easy(idx)

    def _generate_easy(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx]))
        H, W = self.grid_size
        ih, iw = self.image_size
        x_min, x_max, y_min, y_max = self.pc_range

        road = self._road_mask(rng)

        # --- LiDAR: dense returns on road cells, sparse clutter elsewhere ---
        n_total = self.max_points
        n_road = int(n_total * 0.6)
        road_cells = np.argwhere(road > 0)
        if len(road_cells) == 0:
            road_cells = np.array([[H // 2, W // 2]])
        pick = road_cells[rng.integers(0, len(road_cells), n_road)]
        jitter = rng.uniform(0, 1, (n_road, 2))
        rx = x_min + (pick[:, 1] + jitter[:, 0]) / W * (x_max - x_min)
        ry = y_min + (pick[:, 0] + jitter[:, 1]) / H * (y_max - y_min)
        rz = rng.normal(-1.8, 0.05, n_road)          # flat ground returns
        ri = rng.uniform(0.6, 1.0, n_road)           # bright road surface

        n_bg = n_total - n_road
        bx = rng.uniform(x_min * 1.2, x_max * 1.2, n_bg)  # some out-of-range
        by = rng.uniform(y_min * 1.2, y_max * 1.2, n_bg)
        bz = rng.uniform(-1.5, 3.0, n_bg)             # obstacles/vegetation
        bi = rng.uniform(0.0, 0.5, n_bg)
        pts = np.stack([np.concatenate([rx, bx]), np.concatenate([ry, by]),
                        np.concatenate([rz, bz]), np.concatenate([ri, bi])],
                       axis=1).astype(np.float32)
        pts = pts[rng.permutation(n_total)]

        # --- Camera: top-down render of the same scene + noise ---
        # Nearest-neighbor upsample via index mapping: exact for integer
        # ratios (where it equals np.kron) and correct for ANY image/grid
        # combination, including non-multiples and image_size < grid_size
        # (kron with a zero-or-truncated tile would crash or misalign).
        up = road[(np.arange(ih) * H) // ih][:, (np.arange(iw) * W) // iw]
        img = np.empty((ih, iw, 3), np.float32)
        img[..., 0] = np.where(up > 0, 0.45, 0.15)
        img[..., 1] = np.where(up > 0, 0.45, 0.40)
        img[..., 2] = np.where(up > 0, 0.50, 0.15)
        img += rng.normal(0, 0.05, img.shape).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)
        # uint8 transport: 4x less host->device traffic; the model
        # normalizes back to [0,1] on device (models/fusion.py).
        img = np.round(img * 255.0).astype(np.uint8)

        return {
            "image": img,                            # [ih, iw, 3] uint8 NHWC
            "points": pts,                           # [max_points, 4] float32
            "segmentation": road,                    # [H, W] int64
            "sample_token": f"synthetic_{idx:06d}",
        }

    # -- hard mode (the discriminative benchmark) ---------------------------

    # BEV-surface albedos. Camera-twin lots reuse _ROAD_RGB exactly — the
    # image cannot separate them from road; lidar-twin lots get a visibly
    # different color, and their LiDAR signature matches the road's.
    _BG_RGB = np.array([0.15, 0.40, 0.15], np.float32)
    _ROAD_RGB = np.array([0.45, 0.45, 0.50], np.float32)
    _LOT_LID_RGB = np.array([0.45, 0.33, 0.18], np.float32)

    def _band_mask(self, rng: np.random.Generator,
                   width_lo: float, width_hi: float) -> np.ndarray:
        """One thin straight or curved road band (bool [H, W])."""
        H, W = self.grid_size
        yy, xx = np.mgrid[0:H, 0:W]
        width = rng.uniform(width_lo, width_hi) * W
        if rng.random() < 0.5:  # straight, any angle/offset
            theta = rng.uniform(0, np.pi)
            offset = rng.uniform(-0.35, 0.35) * W
            d = (xx - W / 2) * np.cos(theta) + (yy - H / 2) * np.sin(theta)
            return np.abs(d - offset) < width / 2
        a = rng.uniform(-0.03, 0.03)
        b = rng.uniform(-0.6, 0.6)
        c = rng.uniform(0.2, 0.8) * W
        centre = a * (yy - H / 2) ** 2 + b * (yy - H / 2) + c
        band = np.abs(xx - centre) < width / 2
        return band.T if rng.random() < 0.5 else band

    @staticmethod
    def _rect(rng: np.random.Generator, H: int, W: int,
              h_lo: int, h_hi: int, w_lo: int, w_hi: int,
              anchor=None) -> np.ndarray:
        """Random rectangle mask, optionally centred near `anchor` (r, c)."""
        h = int(rng.integers(h_lo, h_hi + 1))
        w = int(rng.integers(w_lo, w_hi + 1))
        if anchor is None:
            r0 = int(rng.integers(0, max(1, H - h)))
            c0 = int(rng.integers(0, max(1, W - w)))
        else:
            r0 = int(np.clip(anchor[0] - h // 2, 0, max(0, H - h)))
            c0 = int(np.clip(anchor[1] - w // 2, 0, max(0, W - w)))
        m = np.zeros((H, W), bool)
        m[r0:r0 + h, c0:c0 + w] = True
        return m

    def _generate_hard(self, idx: int) -> Dict[str, np.ndarray]:
        # Distinct stream tag (7) so hard samples never mirror easy ones.
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx, 7]))
        H, W = self.grid_size
        ih, iw = self.image_size
        x_min, x_max, y_min, y_max = self.pc_range

        # --- BEV layout: thin roads, vehicles, two distractor lot kinds ---
        road = np.zeros((H, W), bool)
        for _ in range(int(rng.integers(1, 4))):
            road |= self._band_mask(rng, 0.03, 0.06)
        if not road.any():  # degenerate curved band fully off-grid
            road[:, W // 2 - 1:W // 2 + 1] = True

        vehicles = np.zeros((H, W), bool)
        road_cells = np.argwhere(road)
        for _ in range(int(rng.integers(2, 7))):
            anchor = road_cells[rng.integers(0, len(road_cells))]
            vehicles |= self._rect(rng, H, W, 2, 3, 2, 4, anchor=anchor)

        lot_cam = np.zeros((H, W), bool)   # camera-twin (image == road)
        lot_lid = np.zeros((H, W), bool)   # lidar-twin (cloud == road)
        for _ in range(int(rng.integers(1, 3))):
            lot_cam |= self._rect(rng, H, W, 6, 14, 6, 14)
        for _ in range(int(rng.integers(1, 3))):
            lot_lid |= self._rect(rng, H, W, 6, 14, 6, 14)
        lot_cam &= ~road
        lot_lid &= ~(road | lot_cam)

        drivable = road & ~vehicles
        seg = drivable.astype(np.int64)

        # --- LiDAR: per-region point populations -------------------------
        n_total = self.max_points
        regions = []  # (mask, count, z_sampler, intensity_sampler)

        def flat_z(n):
            return rng.normal(-1.8, 0.12, n)

        plan = [
            (drivable, 0.18, flat_z, lambda n: rng.uniform(0.55, 0.95, n)),
            (vehicles, 0.07, lambda n: rng.uniform(-1.4, 0.4, n),
             lambda n: rng.uniform(0.3, 0.9, n)),
            # camera-twin lot: flat like road but LOW intensity — the cloud
            # is what tells it apart from drivable.
            (lot_cam, 0.08, flat_z, lambda n: rng.uniform(0.05, 0.30, n)),
            # lidar-twin lot: identical z/intensity/density to road — the
            # cloud carries no signal; only the image does.
            (lot_lid, 0.08, flat_z, lambda n: rng.uniform(0.55, 0.95, n)),
        ]
        n_bg = n_total
        for mask, frac, z_fn, i_fn in plan:
            n = int(n_total * frac)
            if mask.any() and n > 0:
                regions.append((np.argwhere(mask), n, z_fn, i_fn))
                n_bg -= n

        parts = []
        for cells, n, z_fn, i_fn in regions:
            pick = cells[rng.integers(0, len(cells), n)]
            jit = rng.uniform(0, 1, (n, 2))
            px = x_min + (pick[:, 1] + jit[:, 0]) / W * (x_max - x_min)
            py = y_min + (pick[:, 0] + jit[:, 1]) / H * (y_max - y_min)
            parts.append(np.stack([px, py, z_fn(n), i_fn(n)], axis=1))
        # Background clutter (incl. some out-of-range, as in easy mode).
        bx = rng.uniform(x_min * 1.2, x_max * 1.2, n_bg)
        by = rng.uniform(y_min * 1.2, y_max * 1.2, n_bg)
        parts.append(np.stack([bx, by, rng.uniform(-1.6, 2.5, n_bg),
                               rng.uniform(0.0, 0.5, n_bg)], axis=1))
        pts = np.concatenate(parts).astype(np.float32)

        # Angular-dropout wedges (sensor occlusion): returns whose bearing
        # falls inside a wedge are lost — displaced out of range, where the
        # encoder's validity mask drops them. The camera must carry those
        # regions.
        if rng.random() < 0.7:
            ang = np.arctan2(pts[:, 1], pts[:, 0])
            for _ in range(int(rng.integers(1, 3))):
                centre = rng.uniform(-np.pi, np.pi)
                half = np.deg2rad(rng.uniform(12, 35))
                d = np.abs((ang - centre + np.pi) % (2 * np.pi) - np.pi)
                pts[d < half, 0] = 2.5 * x_max
        pts = pts[rng.permutation(n_total)]

        # --- Camera: albedo render + shadows, occluders, fog, noise ------
        color = np.empty((H, W, 3), np.float32)
        color[:] = self._BG_RGB + rng.normal(0, 0.02, 3).astype(np.float32)
        color[road | lot_cam] = self._ROAD_RGB + \
            rng.normal(0, 0.015, 3).astype(np.float32)
        color[lot_lid] = self._LOT_LID_RGB + \
            rng.normal(0, 0.015, 3).astype(np.float32)
        color[vehicles] = rng.uniform(0.55, 0.95, 3).astype(np.float32)
        img = color[(np.arange(ih) * H) // ih][:, (np.arange(iw) * W) // iw]

        yy, xx = np.mgrid[0:ih, 0:iw]
        shade = np.ones((ih, iw), np.float32)
        for _ in range(int(rng.integers(1, 4))):  # elliptical shadows
            cy, cx = rng.uniform(0, ih), rng.uniform(0, iw)
            ry, rx = rng.uniform(0.10, 0.35) * ih, rng.uniform(0.10, 0.35) * iw
            a = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = dy * np.cos(a) + dx * np.sin(a)
            v = -dy * np.sin(a) + dx * np.cos(a)
            shade[(u / ry) ** 2 + (v / rx) ** 2 < 1] *= rng.uniform(0.35, 0.6)
        img = img * shade[..., None]

        for _ in range(int(rng.integers(1, 4))):  # occluder patches
            h = int(rng.integers(ih // 16, ih // 5))
            w = int(rng.integers(iw // 16, iw // 5))
            r0 = int(rng.integers(0, ih - h))
            c0 = int(rng.integers(0, iw - w))
            img[r0:r0 + h, c0:c0 + w] = rng.uniform(0, 1, 3)

        if rng.random() < 0.3:  # fog/washout: camera nearly uninformative
            img = 0.5 + (img - 0.5) * rng.uniform(0.15, 0.35)
        img += rng.normal(0, 0.08, img.shape).astype(np.float32)
        img = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)

        return {
            "image": img,                            # [ih, iw, 3] uint8 NHWC
            "points": pts,                           # [max_points, 4] float32
            "segmentation": seg,                     # [H, W] int64
            "sample_token": f"synthetic_hard_{idx:06d}",
        }


def create_synthetic_datasets(config: DataConfig,
                              seed: int = 0
                              ) -> Tuple[SyntheticMultiModalDataset,
                                         SyntheticMultiModalDataset]:
    """Train/val split with disjoint seeds (reference §2.26:
    create_synthetic_dataloaders(num_train=800, num_val=200))."""
    difficulty = getattr(config, "synthetic_difficulty", "easy")
    train = SyntheticMultiModalDataset(
        num_samples=config.synthetic_num_train, image_size=config.image_size,
        grid_size=config.grid_size, max_points=config.max_points,
        pc_range=config.pc_range, seed=seed, difficulty=difficulty)
    val = SyntheticMultiModalDataset(
        num_samples=config.synthetic_num_val, image_size=config.image_size,
        grid_size=config.grid_size, max_points=config.max_points,
        pc_range=config.pc_range, seed=seed + 10_000, difficulty=difficulty)
    return train, val
