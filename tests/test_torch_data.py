"""The port's copies of the synthetic dataset and the batching pipeline
against the JAX package's, on the CPU: samples, batches and their order are
byte-identical for the same seed and epoch (shuffle by
SeedSequence([seed, epoch]), padding of the final batch by repetition with
sample_mask 0 and all-ignored labels, sample_index, the per-sample cell
sort). Tolerance: none, every array is compared exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from lmsu_tpu.config import DataConfig as JData
from lmsu_tpu.data import create_datasets as jax_create_datasets
from lmsu_tpu.data.pipeline import Batcher as JBatcher
from lmsu_tpu.data.pipeline import make_loader as jax_make_loader
from lmsu_tpu.data.rasterize import make_point_sorter as jax_point_sorter
from lmsu_tpu.data.synthetic import SyntheticMultiModalDataset as JSynthetic
from lmsu_tpu_torch.config import DataConfig
from lmsu_tpu_torch.data import Batcher, create_datasets, make_loader, write_pack
from lmsu_tpu_torch.data.rasterize import make_point_sorter
from lmsu_tpu_torch.data.synthetic import SyntheticMultiModalDataset

torch.set_num_threads(2)

SMALL = dict(image_size=(64, 64), grid_size=(16, 16), max_points=512)
PC6 = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("difficulty", ["easy", "hard"])
@pytest.mark.parametrize("size", ["default", "small"])
def test_synthetic_samples_byte_identical(difficulty, size):
    kw = dict(SMALL) if size == "small" else {}
    j = JSynthetic(num_samples=4, seed=7, difficulty=difficulty, cache=False, **kw)
    p = SyntheticMultiModalDataset(num_samples=4, seed=7, difficulty=difficulty,
                                   cache=False, **kw)
    for i in (0, 3):
        _assert_same(j[i], p[i])


def test_create_datasets_split_and_refusals(tmp_path):
    """Synthetic splits as the JAX package's; packs of them (written by the
    port) and a PandaSet root read as the JAX package reads them (a root
    without scenes gives empty splits); an unknown kind is a ValueError."""
    jd = JData(dataset="synthetic", synthetic_num_train=5, synthetic_num_val=3,
               synthetic_difficulty="hard", **SMALL)
    pd = DataConfig(dataset="synthetic", synthetic_num_train=5, synthetic_num_val=3,
                    synthetic_difficulty="hard", **SMALL)
    (jt, jv), (pt, pv) = jax_create_datasets(jd), create_datasets(pd)
    assert (len(pt), len(pv)) == (len(jt), len(jv)) == (5, 3)
    _assert_same(jt[4], pt[4])
    _assert_same(jv[2], pv[2])
    for split, ds in (("train", pt), ("val", pv)):
        write_pack(ds, str(tmp_path / "packs" / split))
    for name, root in (("packed", tmp_path / "packs"), ("pandaset", tmp_path / "empty")):
        root.mkdir(exist_ok=True)
        kw = dict(dataset=name, root=str(root))
        (jt2, jv2) = jax_create_datasets(dataclasses.replace(jd, **kw))
        (pt2, pv2) = create_datasets(dataclasses.replace(pd, **kw))
        assert (len(pt2), len(pv2)) == (len(jt2), len(jv2))
        assert type(pt2).__name__ == type(jt2).__name__
        if name == "packed":
            _assert_same(jt2[4], pt2[4])
            _assert_same(pt2[4], pt[4])
    with pytest.raises(ValueError):
        create_datasets(dataclasses.replace(pd, dataset="nope"))


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, False, 0), (True, True, 3),
                                                       (False, False, 2)])
def test_batcher_batches_and_order_identical(shuffle, drop_last, workers):
    """Two epochs of 7 samples in batches of 3: the same shuffles, the final
    batch padded (or dropped) the same way, the cell sort applied per
    sample."""
    kw = dict(num_samples=7, seed=3, **SMALL)
    jb = JBatcher(JSynthetic(**kw), 3, shuffle=shuffle, seed=11, drop_last=drop_last,
                  num_shards=1, shard_index=0, decode_workers=workers,
                  sample_transform=jax_point_sorter((16, 16), PC6))
    pb = Batcher(SyntheticMultiModalDataset(**kw), 3, shuffle=shuffle, seed=11,
                 drop_last=drop_last, decode_workers=workers,
                 sample_transform=make_point_sorter((16, 16), PC6))
    assert len(jb) == len(pb) == (2 if drop_last else 3)
    orders = []
    for epoch in (0, 1):
        jb.set_epoch(epoch)
        pb.set_epoch(epoch)
        jbs, pbs = list(jb), list(pb)
        assert len(jbs) == len(pbs) == len(pb)
        for a, b in zip(jbs, pbs):
            _assert_same(a, b)
        orders.append(np.concatenate([b["sample_index"] for b in pbs]))
        if not drop_last:
            last = pbs[-1]
            assert last["sample_mask"].tolist() == [True, False, False]
            assert (last["segmentation"][1:] == -1).all()
            assert (last["sample_index"][1:] == last["sample_index"][0]).all()
    assert (not np.array_equal(*orders)) == shuffle


def test_prefetch_loader_identical_and_releases_early_break():
    kw = dict(num_samples=5, seed=1, **SMALL)
    jl = jax_make_loader(JSynthetic(**kw), 2, shuffle=True, seed=4, num_shards=1,
                         shard_index=0, decode_workers=2)
    pl = make_loader(SyntheticMultiModalDataset(**kw), 2, shuffle=True, seed=4,
                     decode_workers=2)
    for epoch in (0, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jbs, pbs = list(jl), list(pl)
        assert len(pbs) == len(pl) == 3
        for a, b in zip(jbs, pbs):
            _assert_same(a, b)
    for b in pl:  # an abandoned epoch leaves the next one whole
        break
    assert len(list(pl)) == 3
