"""The port's PandaSet reader, packs and native host ops against the JAX
package's, on the CPU, on a fabricated scene tree (the layout of
tests/test_pandaset_e2e.py: two scenes of four frames, 60x80 JPEGs,
700-point clouds with a few NaN coordinates, one frame missing its semseg).

Held with exact equality throughout (arrays compared byte for byte, so a NaN
must sit at the same place with the same bits): the scene list, split and
index; every sample's image, points, point_valid, segmentation and token
with max_points above and below the cloud size, pad_points_are_valid both
ways and two seeds, through the native route (native/libbev_ops.so loaded
by both packages) and the numpy route (`_load` patched to None in both);
remap_semantic, rasterize_bev and the cell sort; the decoded cache; packs
written by either package (every file byte-identical, each loads in the
other) and their four refusals; create_datasets for all three kinds."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lmsu_tpu.config import DataConfig as JData
from lmsu_tpu.data import PackedDataset as JPacked
from lmsu_tpu.data import PandaSetDataset as JPandaSet
from lmsu_tpu.data import create_datasets as jax_create_datasets
from lmsu_tpu.data import list_scenes as jax_list_scenes
from lmsu_tpu.data import native as jax_native
from lmsu_tpu.data import rasterize as jax_rasterize
from lmsu_tpu.data import split_scenes as jax_split_scenes
from lmsu_tpu.data import write_pack as jax_write_pack
from lmsu_tpu_torch.config import DataConfig
from lmsu_tpu_torch.data import (Batcher, PackedDataset, PandaSetDataset, create_datasets,
                                 list_scenes, materialize_dataset, native, rasterize,
                                 split_scenes, write_pack)
from lmsu_tpu_torch.data.pandaset import decode_frame

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SCENES = ("001", "002")
SMALL = dict(image_size=(32, 48), grid_size=(8, 8))
PC6 = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)


def make_pandaset_tree(root: Path, rng, n_points: int = 700, nan: bool = True) -> str:
    """Two scenes x 4 frames under `root`: 60x80 JPEGs, clouds over +-80 m
    (some outside +-50 m), with `nan` a few NaN x or y in each, raw class
    ids 0-13 (the drivable set included); scene 002's frame 03 has no
    semseg."""
    import pandas as pd
    from PIL import Image
    for sid in SCENES:
        dirs = [root / sid / "camera" / "front_camera", root / sid / "lidar",
                root / sid / "annotations" / "semseg"]
        for d in dirs:
            d.mkdir(parents=True)
        cam, lid, seg = dirs
        for f in range(4):
            fid = f"{f:02d}"
            Image.fromarray(rng.integers(0, 255, (60, 80, 3)).astype(np.uint8)).save(
                cam / f"{fid}.jpg")
            x = rng.uniform(-80, 80, n_points).astype(np.float32)
            y = rng.uniform(-80, 80, n_points).astype(np.float32)
            if nan:
                x[rng.integers(0, n_points, 5)] = np.nan
                y[rng.integers(0, n_points, 3)] = np.nan
            pd.DataFrame({"x": x, "y": y,
                          "z": rng.uniform(-5, 3, n_points).astype(np.float32),
                          "i": rng.uniform(0, 1, n_points).astype(np.float32)}
                         ).to_pickle(lid / f"{fid}.pkl")
            pd.DataFrame({"class": rng.integers(0, 14, n_points).astype(np.int64)}
                         ).to_pickle(seg / f"{fid}.pkl")
    os.remove(root / "002" / "annotations" / "semseg" / "03.pkl")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    pytest.importorskip("pandas")
    pytest.importorskip("PIL")
    return make_pandaset_tree(tmp_path_factory.mktemp("pandaset"), np.random.default_rng(15))


@pytest.fixture(params=["native", "numpy"])
def host_route(request, monkeypatch):
    """The host ops' route in both packages: the library loaded, or `_load`
    patched to None so every caller takes its numpy path."""
    if request.param == "native":
        if not (jax_native.native_available() and native.native_available()):
            pytest.skip("native/libbev_ops.so does not load here")
    else:
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    assert native.route() == request.param
    return request.param


def same_bytes(a, b, what=""):
    assert type(a) is type(b), what
    if isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


def same_sample(a, b, what=""):
    assert list(a) == list(b), what
    for k in a:
        same_bytes(a[k], b[k], f"{what} {k}")


def test_scene_list_split_and_index(tree):
    scenes = list_scenes(tree)
    assert scenes == jax_list_scenes(tree) == list(SCENES)
    for frac in (0.0, 0.5, 0.8, 1.0):
        assert split_scenes(scenes, frac) == jax_split_scenes(scenes, frac)
    p, j = PandaSetDataset(tree, scenes, **SMALL), JPandaSet(tree, scenes, **SMALL)
    assert p.samples == j.samples and len(p) == 7
    assert [s["frame"] for s in p.samples if s["scene"] == "002"] == ["00", "01", "02"]


@pytest.mark.parametrize("max_points", [500, 900], ids=["downsample", "pad"])
@pytest.mark.parametrize("pad_valid", [False, True], ids=["pad_invalid", "pad_valid"])
@pytest.mark.parametrize("seed", [0, 7])
def test_samples_byte_identical(tree, host_route, max_points, pad_valid, seed):
    kw = dict(max_points=max_points, pad_points_are_valid=pad_valid, seed=seed, **SMALL)
    p, j = PandaSetDataset(tree, SCENES, **kw), JPandaSet(tree, SCENES, **kw)
    nan_rows = 0
    for i in range(len(j)):
        a = p[i]
        same_sample(a, j[i], f"sample {i}")
        nan_rows += int(np.isnan(a["points"]).any(axis=1).sum())
        assert a["image"].dtype == np.uint8 and a["image"].shape == (32, 48, 3)
        assert a["point_valid"].sum() == (max_points if pad_valid else min(700, max_points))
    assert nan_rows > 0  # the NaN coordinates reach the samples


def test_routes_draw_different_subsets(tree, monkeypatch):
    """The native and numpy routes pick different subsets from one seed (so
    each is held to the JAX package's same route), and the labels, which
    rasterize from the full cloud, are the same either way."""
    if not native.native_available():
        pytest.skip("native/libbev_ops.so does not load here")
    kw = dict(max_points=500, **SMALL)
    by_native = PandaSetDataset(tree, SCENES, **kw)[0]
    monkeypatch.setattr(native, "_load", lambda: None)
    by_numpy = PandaSetDataset(tree, SCENES, **kw)[0]
    assert not np.array_equal(by_native["points"], by_numpy["points"], equal_nan=True)
    same_bytes(by_native["segmentation"], by_numpy["segmentation"])


def test_remap_semantic():
    ids = np.arange(-1, 20, dtype=np.int64)
    same_bytes(rasterize.remap_semantic(ids), jax_rasterize.remap_semantic(ids))
    assert rasterize.DRIVABLE_RAW_IDS == jax_rasterize.DRIVABLE_RAW_IDS
    assert list(np.flatnonzero(rasterize.remap_semantic(ids)) - 1) == [6, 7, 8, 9, 10, 12]


@pytest.mark.parametrize("labels", ["2class", "multiclass"])
def test_rasterize_bev(host_route, labels):
    """First-nonzero-wins in point order over clouds with NaN coordinates
    and points outside the range, both routes, 2-class and multiclass."""
    rng = np.random.default_rng(3)
    n = 3000
    x = rng.uniform(-60, 60, n).astype(np.float32)
    y = rng.uniform(-60, 60, n).astype(np.float32)
    x[::37] = np.nan
    y[5::41] = np.nan
    lab = rng.integers(0, 2 if labels == "2class" else 5, n).astype(np.int64)
    for grid in ((8, 8), (16, 24), (64, 64)):
        if host_route == "native":
            got = native.rasterize_bev_native(x, y, lab, grid)
            want = jax_native.rasterize_bev_native(x, y, lab, grid)
        else:
            got = rasterize.rasterize_bev(x, y, lab, grid)
            want = jax_rasterize.rasterize_bev(x, y, lab, grid)
        same_bytes(got, want, str(grid))
        assert got.any()
    empty = np.array([], np.float32)
    same_bytes(rasterize.rasterize_bev(empty, empty, np.array([], np.int64), (8, 8)),
               np.zeros((8, 8), np.int64))


@pytest.mark.parametrize("with_valid", [False, True])
def test_point_sorter_routes(host_route, with_valid):
    """make_point_sorter: the native counting sort and the numpy argsort give
    the JAX package's order bit for bit, NaN and invalid points last."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-60, 60, (800, 4)).astype(np.float32)
    pts[::29, 0] = np.nan
    sample = {"points": pts}
    if with_valid:
        sample["point_valid"] = np.arange(800) < 650
    got = rasterize.make_point_sorter((16, 16), PC6)(sample)
    want = jax_rasterize.make_point_sorter((16, 16), PC6)(sample)
    same_sample(got, want)
    key = rasterize.bev_cell_key(got["points"], (16, 16), PC6, got.get("point_valid"))
    assert (np.diff(key) >= 0).all() and key[-1] == 256


def test_decoded_cache(tree, monkeypatch):
    """decoded_cache: equal to a fresh decode, no decode on the second read,
    read-only arrays handed out in shallow copies. The cell sort, the
    Batcher and materialize_dataset copy: no batch array shares memory with
    the cache, every batch array is writable (torch.from_numpy takes it),
    and after a pass the cache still equals a fresh decode."""
    kw = dict(max_points=500, pad_points_are_valid=True, seed=3, **SMALL)
    fresh = PandaSetDataset(tree, SCENES, **kw)
    cached = PandaSetDataset(tree, SCENES, cache=True, **kw)
    jcached = JPandaSet(tree, SCENES, cache=True, **kw)
    for i in range(len(fresh)):
        same_sample(cached[i], fresh[i])
        same_sample(cached[i], jcached[i])
    calls = []
    real = cached._decode
    monkeypatch.setattr(cached, "_decode", lambda i: calls.append(i) or real(i))
    held = [cached[i] for i in range(len(cached))]
    assert calls == []
    for s in held:
        for k, v in s.items():
            if isinstance(v, np.ndarray):
                assert not v.flags.writeable, k
                with pytest.raises(ValueError):
                    v[...] = 0
    s = cached[0]
    s["points"] = np.zeros_like(s["points"])  # replacing an entry leaves the cache alone
    assert not np.array_equal(cached[0]["points"], s["points"])
    frozen = [v for s in held for v in s.values() if isinstance(v, np.ndarray)]
    sorter = rasterize.make_point_sorter((8, 8), PC6)
    batches = list(Batcher(cached, 3, shuffle=True, seed=1, sample_transform=sorter))
    batches.append(materialize_dataset(cached, 4, sample_transform=sorter))
    for b in batches:
        for k, v in b.items():
            assert v.flags.writeable, k
            assert not any(np.shares_memory(v, f) for f in frozen), k
            torch.from_numpy(v)
    for i in range(len(fresh)):
        same_sample(cached[i], fresh[i])


def _pack_files(d):
    return {f: (Path(d) / f).read_bytes() for f in sorted(os.listdir(d))}


def test_packs_both_ways(tree, tmp_path):
    """A pack written by the port and one written by the JAX package are
    byte-identical file for file, and each package reads the other's."""
    kw = dict(max_points=600, seed=5, **SMALL)
    pd_, jd = PandaSetDataset(tree, SCENES, **kw), JPandaSet(tree, SCENES, **kw)
    write_pack(pd_, str(tmp_path / "port"))
    jax_write_pack(jd, str(tmp_path / "jax"))
    port_files, jax_files = _pack_files(tmp_path / "port"), _pack_files(tmp_path / "jax")
    assert sorted(port_files) == ["image.npy", "meta.json", "point_valid.npy", "points.npy",
                                  "sample_token.json", "segmentation.npy"]
    assert port_files == jax_files
    for reader, d in ((PackedDataset, "jax"), (JPacked, "port")):
        packed = reader(str(tmp_path / d))
        assert len(packed) == len(pd_)
        for i in range(len(pd_)):
            same_sample(packed[i], pd_[i], f"{reader.__module__} {i}")
    with pytest.raises(IndexError):
        PackedDataset(str(tmp_path / "jax"))[len(pd_)]


def _break_version(d):
    (d / "meta.json").write_text('{"n": 7, "keys": ["image"], "version": 2}')


def _break_rows(d):
    np.save(d / "image.npy", np.zeros((3, 2), np.uint8))


@pytest.mark.parametrize("fault", ["empty", "no_meta", "version", "rows"])
def test_pack_refusals(tree, tmp_path, fault):
    """The four refusals, as the JAX package makes them: an empty dataset,
    a directory without meta.json (naming prepare_dataset), a version
    mismatch and a field whose row count is not meta's n."""
    if fault == "empty":
        for writer in (write_pack, jax_write_pack):
            with pytest.raises(ValueError, match="empty"):
                writer([], str(tmp_path / "e"))
        return
    d = tmp_path / "pack"
    if fault != "no_meta":
        write_pack(PandaSetDataset(tree, SCENES[:1], max_points=300, **SMALL), str(d))
        {"version": _break_version, "rows": _break_rows}[fault](d)
    error, match = {"no_meta": (FileNotFoundError, "prepare_dataset"),
                    "version": (ValueError, "version 2"),
                    "rows": (ValueError, "image: 3 rows")}[fault]
    for reader in (PackedDataset, JPacked):
        with pytest.raises(error, match=match):
            reader(str(d))


@pytest.mark.parametrize("kind", ["pandaset", "synthetic", "packed"])
def test_create_datasets_each_kind(tree, tmp_path, kind):
    """create_datasets builds each kind as the JAX package does: the same
    classes' samples, split sizes and bytes."""
    kw = dict(dataset=kind, max_points=400, synthetic_num_train=3, synthetic_num_val=2,
              decoded_cache=True, **SMALL)
    root = tree
    if kind == "packed":
        root = str(tmp_path / "packs")
        for split, scenes in (("train", SCENES[:1]), ("val", SCENES[1:])):
            write_pack(PandaSetDataset(tree, scenes, max_points=400, **SMALL),
                       os.path.join(root, split))
    (pt, pv), (jt, jv) = (create_datasets(DataConfig(root=root, **kw)),
                          jax_create_datasets(JData(root=root, **kw)))
    assert type(pt).__name__ == type(jt).__name__
    assert (len(pt), len(pv)) == (len(jt), len(jv)) == {"synthetic": (3, 2)}.get(kind, (4, 3))
    for a, b in ((pt, jt), (pv, jv)):
        for i in range(len(a)):
            same_sample(a[i], b[i], f"{kind} {i}")
    with pytest.raises(ValueError, match="Unknown dataset"):
        create_datasets(dataclasses.replace(DataConfig(), dataset="nuscenes"))


def test_decode_frame_without_pil_or_pandas():
    """The port imports, and decodes a frame's arrays, where PIL and pandas
    cannot be imported: a deployment may install neither."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'pandas'): sys.modules[m] = None\n"
        "import importlib, pkgutil, numpy as np, lmsu_tpu_torch\n"
        "for m in pkgutil.walk_packages(lmsu_tpu_torch.__path__, 'lmsu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from lmsu_tpu_torch.data.pandaset import decode_frame\n"
        "r = np.random.default_rng(0)\n"
        "s = decode_frame(np.zeros((8, 8, 3), np.uint8),\n"
        "                 r.uniform(-60, 60, (300, 4)).astype(np.float32),\n"
        "                 r.integers(0, 14, 300), grid_size=(8, 8), max_points=200,\n"
        "                 pc_range=(-50.0, 50.0, -50.0, 50.0), seed=0, index=1)\n"
        "assert s['points'].shape == (200, 4) and s['segmentation'].any()\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_decode_frame_is_the_datasets_decode(tree, monkeypatch):
    """decode_frame on a frame's arrays (as chip_smoke.py feeds it, without
    the file readers) gives the dataset's sample."""
    from lmsu_tpu_torch.data import pandaset
    kw = dict(max_points=500, seed=9, **SMALL)
    ds = PandaSetDataset(tree, SCENES, **kw)
    s = ds.samples[4]
    got = decode_frame(pandaset.load_image(s["image"], SMALL["image_size"]),
                       pandaset.load_points(s["lidar"]), pandaset.load_class_ids(s["semseg"]),
                       grid_size=SMALL["grid_size"], max_points=500,
                       pc_range=ds.pc_range, seed=9, index=4)
    want = ds[4]
    assert want.pop("sample_token") == f"{s['scene']}_{s['frame']}"
    same_sample(got, want)
