"""PandaSet scenes: indexing and per-frame decode on the host (numpy).

The port's copy of lmsu_tpu/data/pandaset.py, with the same on-disk
contract and the same samples, byte for byte (tests/test_torch_pandaset.py):

  * scene layout <root>/<scene>/{camera/front_camera/*.jpg, lidar/*.pkl,
    annotations/semseg/*.pkl}; a frame counts only when all three files
    exist (reference pandaset_dataset.py:72-99);
  * image: JPEG -> RGB -> bilinear resize to image_size (H, W) -> uint8
    [H, W, 3] (the model divides by 255 on the device);
  * points: the lidar pickle's x, y, z, i columns -> [N, 4] float32;
  * labels: the semseg pickle's raw class ids -> 2-class remap -> a
    first-nonzero-wins BEV raster of the FULL cloud, before any downsample;
  * points downsampled without replacement above max_points, zero-padded
    below, with `point_valid` marking the pad (all True with
    pad_points_are_valid, the reference's quirk: pad points then land at the
    grid centre as real points).

The subset is a pure function of (dataset seed, sample index), drawn from
SeedSequence([seed, index]): the native route (data/native.py) seeds
splitmix64 with its first uint64, the numpy route draws
default_rng(that SeedSequence).choice. The two routes pick different
subsets; each matches the JAX package's same route.

The file readers (`load_image`, `load_points`, `load_class_ids`) import PIL
and pandas when called; `decode_frame` does the rest on numpy arrays, so it
runs where neither package is installed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lmsu_tpu_torch.data import native
from lmsu_tpu_torch.data.rasterize import rasterize_bev, remap_semantic


def list_scenes(root: str) -> List[str]:
    """Sorted scene directory names under the dataset root."""
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def split_scenes(scenes: Sequence[str],
                 train_fraction: float = 0.8) -> Tuple[List[str], List[str]]:
    """The first train_fraction of the scenes train, the rest validate
    (reference train_pandaset.py:84-86)."""
    n_train = int(len(scenes) * train_fraction)
    return list(scenes[:n_train]), list(scenes[n_train:])


def load_image(path: str, image_size: Tuple[int, int]) -> np.ndarray:
    """A JPEG as RGB uint8 [H, W, 3], resized bilinearly to image_size (H, W)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    # PIL takes (width, height).
    img = img.resize((image_size[1], image_size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_points(path: str) -> np.ndarray:
    """A lidar pickle's x, y, z, i columns as float32 [N, 4]."""
    import pandas as pd
    df = pd.read_pickle(path)
    return np.stack([df[c].to_numpy(dtype=np.float32) for c in ("x", "y", "z", "i")], axis=1)


def load_class_ids(path: str) -> np.ndarray:
    """A semseg pickle's raw class ids, int64 [N]."""
    import pandas as pd
    return pd.read_pickle(path)["class"].to_numpy(dtype=np.int64)


def decode_frame(image: np.ndarray, points: np.ndarray, raw_ids: np.ndarray, *,
                 grid_size: Tuple[int, int], max_points: int,
                 pc_range: Tuple[float, float, float, float], seed: int, index: int,
                 pad_points_are_valid: bool = False) -> Dict[str, np.ndarray]:
    """One sample from a frame's arrays: `image` as read (uint8 [H, W, 3]),
    the full cloud [N, 4] and its raw class ids [N]. The labels rasterize
    from the full cloud; then the cloud is downsampled (subset drawn from
    SeedSequence([seed, index])) or zero-padded to max_points. Returns
    image, points [max_points, 4], point_valid [max_points] and
    segmentation [H_grid, W_grid] int64."""
    ids2 = remap_semantic(raw_ids)
    bev = native.rasterize_bev_native(points[:, 0], points[:, 1], ids2,
                                      grid_size=grid_size, pc_range=pc_range)
    if bev is None:
        bev = rasterize_bev(points[:, 0], points[:, 1], ids2, grid_size=grid_size,
                            pc_range=pc_range)
    ss = np.random.SeedSequence([seed, index])
    n = points.shape[0]
    drawn = native.sample_or_pad_native(points, max_points,
                                        seed=int(ss.generate_state(1, np.uint64)[0]))
    if drawn is not None:
        pts, valid = drawn
    else:
        if n > max_points:
            choice = np.random.default_rng(ss).choice(n, max_points, replace=False)
            pts = points[choice]
            n_valid = max_points
        else:
            pts = np.vstack([points, np.zeros((max_points - n, 4), np.float32)])
            n_valid = n
        valid = np.arange(max_points) < n_valid
    if pad_points_are_valid:
        valid = np.ones(max_points, bool)
    return {"image": image, "points": pts, "point_valid": valid, "segmentation": bev}


class PandaSetDataset:
    """2-class BEV segmentation samples from PandaSet scenes.

    With cache=True (DataConfig.decoded_cache) each decoded sample is kept
    in host memory with its arrays made read-only, and a read returns a
    shallow copy of its dict: a transform may replace entries but cannot
    write into the cache. Everything downstream copies (the Batcher's
    np.stack, materialize_dataset, the cell sort)."""

    def __init__(self, root: str, scene_ids: Sequence[str],
                 image_size: Tuple[int, int] = (256, 256),
                 grid_size: Tuple[int, int] = (64, 64),
                 max_points: int = 5000,
                 pc_range: Tuple[float, float, float, float] = (-50, 50, -50, 50),
                 pad_points_are_valid: bool = False,
                 seed: int = 0,
                 cache: bool = False,
                 verbose: bool = False):
        self.root = root
        self.scene_ids = list(scene_ids)
        self.image_size = image_size
        self.grid_size = grid_size
        self.max_points = max_points
        self.pc_range = pc_range
        self.pad_points_are_valid = pad_points_are_valid
        self.seed = seed
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = {} if cache else None
        self.samples = self._index_scenes(verbose)
        if verbose:
            print(f"Indexed {len(self.samples)} valid samples from "
                  f"{len(self.scene_ids)} scenes")

    def _index_scenes(self, verbose: bool) -> List[Dict[str, str]]:
        samples = []
        for sid in self.scene_ids:
            cam_dir = os.path.join(self.root, sid, "camera", "front_camera")
            lidar_dir = os.path.join(self.root, sid, "lidar")
            seg_dir = os.path.join(self.root, sid, "annotations", "semseg")
            if not all(os.path.isdir(d) for d in (cam_dir, lidar_dir, seg_dir)):
                continue
            frames = sorted(f[:-4] for f in os.listdir(cam_dir) if f.endswith(".jpg"))
            usable = 0
            for fid in frames:
                paths = {"image": os.path.join(cam_dir, f"{fid}.jpg"),
                         "lidar": os.path.join(lidar_dir, f"{fid}.pkl"),
                         "semseg": os.path.join(seg_dir, f"{fid}.pkl")}
                if all(os.path.exists(p) for p in paths.values()):
                    samples.append({"scene": sid, "frame": fid, **paths})
                    usable += 1
            if verbose:
                print(f"Scene {sid}: {usable}/{len(frames)} frames usable")
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and idx in self._cache:
            return dict(self._cache[idx])
        item = self._decode(idx)
        if self._cache is not None:
            for v in item.values():
                if isinstance(v, np.ndarray):
                    v.flags.writeable = False
            self._cache[idx] = item
            return dict(item)
        return item

    def _decode(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        item = decode_frame(load_image(s["image"], self.image_size), load_points(s["lidar"]),
                            load_class_ids(s["semseg"]), grid_size=self.grid_size,
                            max_points=self.max_points, pc_range=self.pc_range,
                            seed=self.seed, index=idx,
                            pad_points_are_valid=self.pad_points_are_valid)
        item["sample_token"] = f"{s['scene']}_{s['frame']}"
        return item


def create_pandaset_datasets(config, verbose: bool = False
                             ) -> Tuple[PandaSetDataset, PandaSetDataset]:
    """DataConfig.dataset == "pandaset": the scenes under `root`, split by
    train_fraction."""
    train_scenes, val_scenes = split_scenes(list_scenes(config.root), config.train_fraction)
    kw = dict(image_size=config.image_size, grid_size=config.grid_size,
              max_points=config.max_points, pc_range=config.pc_range,
              pad_points_are_valid=config.pad_points_are_valid,
              cache=config.decoded_cache, verbose=verbose)
    return (PandaSetDataset(config.root, train_scenes, **kw),
            PandaSetDataset(config.root, val_scenes, **kw))
